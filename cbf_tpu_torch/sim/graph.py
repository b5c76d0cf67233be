"""Graph-Laplacian utilities and consensus/pursuit control laws
(counterpart: cbf_tpu/sim/graph.py).

Neighbours are an N x N 0/1 adjacency derived from any Laplacian's
off-diagonal nonzeros (the rps ``topological_neighbors`` "nonzero"
semantics), and the consensus law sum_j (x_j - x_i) over neighbours is
one product. The Laplacians are numpy (built on the host once per
scenario); the adjacency is a tensor on an explicit device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def complete_gl(n: int) -> np.ndarray:
    """Complete-graph Laplacian (rps completeGL equivalent)."""
    return n * np.eye(n) - np.ones((n, n))


def cycle_gl(n: int) -> np.ndarray:
    """Directed ring Laplacian, the shape both reference scenarios
    hand-write for cyclic pursuit: -1 on the diagonal, +1 on the
    successor."""
    L = -np.eye(n)
    L += np.eye(n, k=1)
    L[-1, 0] = 1.0
    return L


def adjacency_from_laplacian(L, *, dtype=torch.float32,
                             device="cpu") -> torch.Tensor:
    """0/1 adjacency from off-diagonal nonzeros (any nonzero off-diagonal
    entry of row i marks a neighbour), as a ``dtype`` tensor on
    ``device``."""
    L = np.asarray(L)
    off = ~np.eye(L.shape[0], dtype=bool)
    return torch.as_tensor((L != 0) & off, dtype=dtype, device=device)


def consensus_velocities(X, A):
    """sum_{j in N(i)} (x_j - x_i) for every agent at once.

    X (2, N) positions; A (N, N) 0/1 adjacency (row i = neighbours of i).
    Returns (2, N)."""
    deg = torch.sum(A, dim=1)                      # (N,)
    return X @ A.T - X * deg[None, :]


def cyclic_pursuit_velocities(X, A, theta: float):
    """Consensus rotated by ``theta``: v -> R(theta) v, the obstacle
    ring's control law. ``theta`` is rounded to the positions' dtype
    before cos and sin, as the JAX package takes them of a weakly typed
    scalar; ``torch.full`` keeps that a fill on the device (no host
    copy), so the law is capture-safe."""
    cons = consensus_velocities(X, A)
    th = torch.full((), theta, dtype=cons.dtype, device=cons.device)
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return rot @ cons
