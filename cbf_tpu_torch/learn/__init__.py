"""Differentiable safety-parameter tuning (counterpart: cbf_tpu/learn/)."""

from cbf_tpu_torch.learn.tuning import (  # noqa: F401
    TrainConfig,
    TunableParams,
    init_params,
    make_loss_and_grad_fn,
    make_loss_fn,
    make_train_step,
    params_to_cbf,
)
