"""The port's graph Laplacians, consensus laws and position controllers
(cbf_tpu_torch.sim.graph, .controllers) against the JAX package's, on the
same numpy inputs.

Tolerances: float64 atol 1e-12; float32 within 1 ulp (cos/sin, atan2 and
the small products may round an ulp apart between PyTorch and XLA); the
Laplacians, adjacencies and boolean outputs exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.sim import controllers as jctl
from cbf_tpu.sim import graph as jgr
from cbf_tpu_torch.scenarios import cross_and_rescue as tcar
from cbf_tpu_torch.sim import controllers as tctl
from cbf_tpu_torch.sim import graph as tgr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=["float32", "float64"])
def dtype_name(request):
    if request.param == "float64":
        request.getfixturevalue("x64")
    return request.param


def _close(got: torch.Tensor, want, dtype_name: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if dtype_name == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


LAPLACIANS = {"cycle5": lambda: jgr.cycle_gl(5),
              "cycle6": lambda: jgr.cycle_gl(6),
              "complete5": lambda: jgr.complete_gl(5),
              "goal": lambda: tcar.L2_GOAL}


@pytest.mark.parametrize("n", [1, 2, 5, 6])
def test_laplacians_equal(n):
    np.testing.assert_array_equal(tgr.complete_gl(n), jgr.complete_gl(n))
    if n > 1:
        np.testing.assert_array_equal(tgr.cycle_gl(n), jgr.cycle_gl(n))


@pytest.mark.parametrize("name", sorted(LAPLACIANS))
def test_adjacency_equal(name, dtype_name):
    L = LAPLACIANS[name]()
    want = np.asarray(jgr.adjacency_from_laplacian(L).astype(dtype_name))
    got = tgr.adjacency_from_laplacian(L, dtype=getattr(torch, dtype_name))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().dtype == want.dtype


@pytest.mark.parametrize("name,theta", [("cycle5", None), ("complete5", None),
                                        ("goal", None),
                                        ("cycle5", -np.pi / 5),
                                        ("cycle6", -np.pi / 6)])
def test_consensus_and_pursuit(name, theta, dtype_name, rng):
    L = LAPLACIANS[name]()
    n = L.shape[0]
    X = rng.uniform(-1.5, 1.5, (2, n)).astype(dtype_name)
    A_j = jgr.adjacency_from_laplacian(L).astype(dtype_name)
    A_t = tgr.adjacency_from_laplacian(L, dtype=getattr(torch, dtype_name))
    if theta is None:
        want = jgr.consensus_velocities(jnp.asarray(X), A_j)
        got = tgr.consensus_velocities(torch.as_tensor(X), A_t)
    else:
        want = jgr.cyclic_pursuit_velocities(jnp.asarray(X), A_j, theta)
        got = tgr.cyclic_pursuit_velocities(torch.as_tensor(X), A_t, theta)
    _close(got, want, dtype_name)


@pytest.mark.parametrize("law", ["si", "si capped", "unicycle",
                                 "at_position"])
def test_position_controllers(law, dtype_name, rng):
    n = 24
    x = rng.uniform(-1, 1, (3, n)).astype(dtype_name)
    x[2] *= np.pi
    goals = rng.uniform(-1, 1, (2, n)).astype(dtype_name)
    goals[:, :3] = x[:2, :3]          # agents already at their goals
    goals[:, 3] = x[:2, 3] + 0.01     # within the position error
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jg, tg = jnp.asarray(goals), torch.as_tensor(goals)
    if law.startswith("si"):
        limit = 0.15 if law == "si capped" else 10.0
        want = jctl.si_position_controller(jx[:2], jg, 0.8, limit)
        got = tctl.si_position_controller(tx[:2], tg, 0.8, limit)
    elif law == "unicycle":
        want = jctl.unicycle_position_controller(jx, jg)
        got = tctl.unicycle_position_controller(tx, tg)
    else:
        want = jctl.at_position(jx[:2], jg)
        got = tctl.at_position(tx[:2], tg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) >= 4
        return
    _close(got, want, dtype_name)
