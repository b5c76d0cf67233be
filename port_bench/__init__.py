"""The benchmark of the PyTorch and CUDA port (``cbf_tpu_torch``).

``python3 -m port_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the card and prints one JSON result
line; ``README.md`` beside this file says how cells, configurations and
per-layer metrics are added as files.
"""
