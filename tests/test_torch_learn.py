"""The port's trainer (cbf_tpu_torch/learn/tuning.py, parallel/ensemble.py)
held to the JAX package's on the CPU: the loss, its gradient and one Adam
step at N=16, E=2 over the same spawn (the port draws JAX's stream), the
JAX side on ``make_mesh(n_dp=1, n_sp=1)``; every rejection of the
differentiable path; remat and forced streaming.

Tolerances: float64 (float64 parameters on both sides) rtol 1e-9; float32
rtol 1e-5 on the loss and 1e-4 on the gradients (two summation orders
over an 8-step float32 rollout); the Adam step's parameters within 1e-6
(both packages normalise the first step's gradient to the rate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.learn import tuning as jt
from cbf_tpu.parallel import make_mesh
from cbf_tpu.parallel.ensemble import ensemble_initial_states as j_init
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu_torch import convert
from cbf_tpu_torch.errors import OutOfSliceError
from cbf_tpu_torch.learn import tuning as tt
from cbf_tpu_torch.parallel import ensemble as tens
from cbf_tpu_torch.parallel.mesh import make_mesh as port_mesh
from cbf_tpu_torch.scenarios import swarm as tsw

N = 16
DENSE = dict(n=N, steps=0, k_neighbors=4, pack_spacing=0.02,
             spawn_half_width_override=0.45)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cfg(jcfg, dtype):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return convert.config_from_fields({**fields, "dtype": dtype})


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_trainer_matches_jax(dtype, x64):
    """Loss, gradients and one Adam step of the port's trainer equal
    JAX's; the spawns the two packages draw are the same bits."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jsw.Config(**DENSE, dtype=jd)
    tcfg = _port_cfg(jcfg, td)
    tc = dict(steps=3, unroll_relax=2, learning_rate=3e-2)
    st_j = j_init(jcfg, [0, 1])
    st_t = tens.ensemble_initial_states(tcfg, [0, 1], device="cpu")
    for a, b in zip(st_j, st_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    params_j = jt.init_params(gamma=0.15, dmin=0.10, k=0.5)
    if dtype == "float64":
        params_j = jt.TunableParams(*(jnp.asarray(p, jnp.float64)
                                      for p in params_j))
    params_t = convert.tunable_params_from_numpy(params_j, dtype=td)
    mesh = make_mesh(n_dp=1, n_sp=1)
    lj, gj = jax.jit(jt.make_loss_and_grad_fn(
        jcfg, mesh, jt.TrainConfig(**tc)))(params_j, *st_j)
    ts_j, opt_j = jt.make_train_step(jcfg, mesh, jt.TrainConfig(**tc))
    p1_j, _, _ = ts_j(params_j, opt_j.init(params_j), *st_j)

    lt, gt = tt.make_loss_and_grad_fn(tcfg, (1, 1), tt.TrainConfig(**tc))(
        params_t, *st_t)
    ts_t, opt_t = tt.make_train_step(tcfg, (1, 1), tt.TrainConfig(**tc))
    p1_t, _, l1_t = ts_t(params_t, opt_t.init(params_t), *st_t)

    loss_rtol, grad_rtol = (1e-9, 1e-9) if dtype == "float64" else \
        (1e-5, 1e-4)
    assert abs(float(lt) - float(lj)) <= loss_rtol * abs(float(lj))
    assert float(l1_t) == float(lt)
    g_j = np.array([float(g) for g in gj])
    g_t = np.array([float(g) for g in gt])
    assert np.all(g_t != 0.0)
    np.testing.assert_allclose(g_t, g_j, rtol=grad_rtol,
                               atol=grad_rtol * np.abs(g_j).max())
    np.testing.assert_allclose([float(p) for p in p1_t],
                               [float(p) for p in p1_j], rtol=0, atol=1e-6)


@pytest.mark.parametrize("override,error,match", [
    ({"gating_rebuild_skin": 0.1}, ValueError, "Verlet caches"),
    ({"certificate": True, "certificate_backend": "sparse",
      "certificate_rebuild_skin": 0.1}, ValueError, "Verlet caches"),
    ({"certificate": True, "certificate_backend": "dense"},
     NotImplementedError, "SPARSE backend"),
    ({"certificate": True, "certificate_backend": "sparse",
      "certificate_warm_start": True}, ValueError, "warm_start"),
    ({"certificate": True, "certificate_backend": "sparse",
      "certificate_tol": 1e-4}, ValueError, "warm_start/certificate_tol"),
    ({"certificate": True, "certificate_backend": "sparse",
      "certificate_fused": True}, ValueError, "certificate_fused"),
])
def test_trainer_rejections_match_jax(override, error, match):
    """Every combination the JAX trainer rejects raises the same error
    type with the same message (the Verlet caches under unroll_relax
    among them)."""
    jcfg = jsw.Config(n=N, **override)
    tcfg = _port_cfg(jcfg, torch.float32)
    with pytest.raises(error) as jerr:
        jt.make_loss_fn(jcfg, make_mesh(n_dp=1, n_sp=1))
    with pytest.raises(error, match=match) as terr:
        tt.make_loss_fn(tcfg, (1, 1))
    assert str(terr.value) == str(jerr.value)


def test_trainer_sharded_paths_raise():
    cfg = tsw.Config(n=N)
    with pytest.raises(OutOfSliceError, match="Queue A10"):
        tt.make_loss_fn(cfg, (1, 2))
    with pytest.raises(ValueError, match="gating='streaming'"):
        tt.make_loss_fn(dataclasses.replace(cfg, gating="streaming"), (1, 2))
    with pytest.raises(OutOfSliceError, match="Queue A10"):
        tens.sharded_swarm_rollout(cfg, port_mesh(devices="cpu"), [0],
                                   partition="spatial")
    for dp, sp in ((2, 1), (1, 2)):
        with pytest.raises(OutOfSliceError, match="Queue A10"):
            port_mesh(n_dp=dp, n_sp=sp, devices="cpu")


def test_remat_and_forced_streaming_keep_the_gradient():
    """``remat`` recomputes each step on the backward pass and changes no
    bit of the loss or gradient; ``gating="streaming"`` selects through
    the streaming kernel's contract, the same selection, so the same
    bits."""
    cfg = tsw.Config(**DENSE)
    state = tens.ensemble_initial_states(cfg, [0, 1], device="cpu")
    params = tt.init_params(gamma=0.15, dmin=0.10, k=0.5, device="cpu")
    out = {}
    for name, c, remat in (("remat", cfg, True), ("plain", cfg, False),
                           ("streaming", dataclasses.replace(
                               cfg, gating="streaming"), True)):
        fn = tt.make_loss_and_grad_fn(c, None, tt.TrainConfig(
            steps=3, remat=remat))
        out[name] = fn(params, *state)
    for name in ("plain", "streaming"):
        assert torch.equal(out[name][0], out["remat"][0])
        for a, b in zip(out[name][1], out["remat"][1]):
            assert torch.equal(a, b)


def test_train_step_descends_two_layers():
    """Two-layer training (the sparse certificate through its implicit
    gradient) at N=16: finite losses, the later ones below the first."""
    cfg = tsw.Config(**DENSE, certificate=True, certificate_backend="sparse",
                     certificate_iters=30, certificate_cg_iters=4)
    state = tens.ensemble_initial_states(cfg, [0, 1], device="cpu")
    ts, opt = tt.make_train_step(cfg, None, tt.TrainConfig(
        steps=2, learning_rate=3e-2))
    params = tt.init_params(gamma=0.15, dmin=0.10, k=0.5, device="cpu")
    st = opt.init(params)
    losses = []
    for _ in range(3):
        params, st, loss = ts(params, st, *state)
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert min(losses[1:]) < losses[0], losses
