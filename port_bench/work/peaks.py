"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A run prints the
card's name and power limit beside every share it reports."""

PEAKS = {
    "card": "NVIDIA H100 SXM",
    # float32 outside the tensor cores, one FMA counted as 2 operations
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "power_limit_w": 700.0,
}
