"""What one k-NN search must do, from its shapes and its data alone —
whatever kernel runs it: the operations and bytes a roofline divides.

A search over B members of N agents in 2-D keeps, per agent, the k
nearest others within a radius, the in-radius count and the nearest
distance to any other agent.

- Operations: 8 float operations per ordered pair within a member (two
  differences, two products, a sum, the radius and self tests, the
  nearest-any minimum), plus k per in-radius candidate (its place among
  the kept k). One FMA would count as 2, as the published peak does.
- Bytes: each input read once and each output written once: the (B, N,
  2) float32 positions (and a per-member radius array where one is
  passed), the (B, N, k) int32 indices and float32 distances, the (B, N)
  float32 nearest distances and int32 counts.
"""

from __future__ import annotations

from port_bench.work.peaks import PEAKS


def search_work(members: int, n: int, k: int, candidates: int,
                radius_array: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one search; ``candidates`` is the number of
    in-radius (agent, other agent) pairs over all members."""
    ops = 8 * members * n * (n - 1) + k * candidates
    nbytes = (members * n * 2 * 4 + (members * 4 if radius_array else 0)
              + members * n * k * (4 + 4) + members * n * (4 + 4))
    return ops, nbytes


def bound_s(ops: int, nbytes: int, peaks: dict = PEAKS) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])


def candidates(x, radius: float) -> int:
    """In-radius ordered pairs of (..., N, 2) positions (0 < d^2 < r^2,
    float32 difference form), summed over the leading axes."""
    import torch

    x = x.to(torch.float32)
    dx = x[..., :, None, 0] - x[..., None, :, 0]
    dy = x[..., :, None, 1] - x[..., None, :, 1]
    d2 = dx * dx + dy * dy
    r = torch.tensor(radius, dtype=torch.float32, device=x.device)
    return int(torch.sum((d2 < r * r) & (d2 > 0)))
