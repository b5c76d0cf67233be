"""The reference scenarios written against :mod:`cbf_tpu_torch.compat`
only, as a user migrating from the reference stack would (counterparts:
examples/*_compat.py). Run each as ``python -m
cbf_tpu_torch.examples.<name>``."""
