"""The port's dynamics families (cbf_tpu_torch.scenarios.swarm with
dynamics="double", "unicycle" and "mixed"), its sim layer
(cbf_tpu_torch.sim.robotarium, .transformations) and the filter's
per-agent path (cbf_tpu_torch.core.filter with f (N, 4, 4)) against the
JAX package's, function by function on the same numpy inputs and as whole
rollouts from the same carried-across state (cbf_tpu_torch.convert, the
headings included).

Tolerances: float64 atol 1e-10 on x, v and theta of a rollout, 1e-12 on
single functions (cos/sin may round an ulp apart between PyTorch and
XLA); float32 rollouts atol 1e-5 on x and theta and 1e-4 on v (the
unicycle's v is a difference quotient over dt = 0.033, which multiplies a
position ulp ~30x), min distance atol 1e-6; every count exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.core import filter as jfil
from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.sim import robotarium as jrob
from cbf_tpu.sim import transformations as jtr
from cbf_tpu_torch import convert
from cbf_tpu_torch.core import filter as tfil
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.sim import robotarium as trob
from cbf_tpu_torch.sim import transformations as ttr
from cbf_tpu_torch.solvers import exact2d as tqp

COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds")
FAMILIES = {"double": {}, "unicycle": {}, "mixed": {"n_double": 8}}


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


def _port_config(jcfg, **override):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    fields.update(override)
    return convert.config_from_fields(fields)


def _run_both(jcfg, **port_override):
    """JAX rollout of ``jcfg`` and the port's compiled rollout on the CPU
    from the same initial state (headings, caches and RTA carry
    included)."""
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    tcfg = _port_config(jcfg, **port_override)
    _, tstep = tsw.make(tcfg, device="cpu")
    ts0 = convert.state_from_reference(s0, device="cpu", dtype=tcfg.dtype)
    tf, to = teng.rollout(tstep, ts0, tcfg.steps)
    return jf, jo, tf, to


def _assert_rollouts_close(jf, jo, tf, to, f64: bool):
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)),
                                      err_msg=name)
    atol_x, atol_v = (1e-10, 1e-10) if f64 else (1e-5, 1e-4)
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance), rtol=0,
                               atol=1e-10 if f64 else 1e-6)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=atol_x)
    np.testing.assert_allclose(tf.v.numpy(), np.asarray(jf.v), rtol=0,
                               atol=atol_v)
    assert isinstance(tf.theta, tuple) == isinstance(jf.theta, tuple)
    if not isinstance(jf.theta, tuple):
        np.testing.assert_allclose(tf.theta.numpy(), np.asarray(jf.theta),
                                   rtol=0, atol=atol_x)
        np.testing.assert_allclose(to.saturation_deficit.numpy(),
                                   np.asarray(jo.saturation_deficit),
                                   rtol=0, atol=atol_v)
    else:
        assert to.saturation_deficit == () and jo.saturation_deficit == ()


# -- the sim layer ----------------------------------------------------------

def test_sim_layer_matches_jax(dtype_name):
    rng = np.random.default_rng(0)
    poses = rng.uniform(-3, 3, size=(3, 50)).astype(dtype_name)
    # Commands from gentle to far past the wheel limit (12.5 rad/s).
    dxu = (rng.normal(size=(2, 50)) * np.array([[0.3], [6.0]])).astype(
        dtype_name)
    dxi = rng.normal(size=(2, 50)).astype(dtype_name) * 0.2
    tol = 1e-12 if dtype_name == "float64" else 2e-6
    pairs = [
        (ttr.uni_to_si_states(torch.as_tensor(poses), 0.05),
         jtr.uni_to_si_states(jnp.asarray(poses), 0.05)),
        (ttr.si_to_uni_dyn(torch.as_tensor(dxi), torch.as_tensor(poses)),
         jtr.si_to_uni_dyn(jnp.asarray(dxi), jnp.asarray(poses))),
        (trob.saturate_unicycle(torch.as_tensor(dxu)),
         jrob.saturate_unicycle(jnp.asarray(dxu))),
        (trob.unicycle_step(torch.as_tensor(poses), torch.as_tensor(dxu),
                            trob.SimParams(dt=0.05)),
         jrob.unicycle_step(jnp.asarray(poses), jnp.asarray(dxu),
                            jrob.SimParams(dt=0.05))),
    ]
    for got, want in pairs:
        assert got.dtype == getattr(torch, dtype_name)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
    # Saturation is proportional: the arc (v/omega) is kept, the wheels
    # stay within their limit.
    sat = trob.saturate_unicycle(torch.as_tensor(dxu)).numpy()
    p = trob.SimParams()
    wr = (2 * sat[0] + sat[1] * p.base_length) / (2 * p.wheel_radius)
    assert np.abs(wr).max() <= p.max_wheel_speed * (1 + 1e-5)
    assert trob.SimParams() == tuple(jrob.SimParams())
    assert trob.ARENA == jrob.ARENA


# -- the step's dynamics functions ------------------------------------------

@pytest.mark.parametrize("family", ["single", "double", "unicycle", "mixed"])
def test_dynamics_functions_match_jax(family, dtype_name):
    kw = {"n_double": 7} if family == "mixed" else {}
    jcfg = jsw.Config(n=20, dynamics=family, n_obstacles=2,
                      dtype=getattr(jnp, dtype_name), **kw)
    tcfg = _port_config(jcfg)
    tol = 1e-12 if dtype_name == "float64" else 2e-6
    for got, want in zip(tsw.barrier_dynamics(tcfg, tcfg.dtype,
                                              device="cpu"),
                         jsw.barrier_dynamics(jcfg, jcfg.dtype)):
        if isinstance(want, bool):
            assert got == want
        else:
            assert got.dtype == tcfg.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jp, tp = jsw.default_cbf(jcfg), tsw.default_cbf(tcfg, device="cpu")
    for got, want in zip(tp, jp):
        np.testing.assert_array_equal(np.asarray(got, dtype_name),
                                      np.asarray(want, dtype_name))
    if family == "mixed":
        np.testing.assert_array_equal(
            tsw.dynamics_mask(tcfg, device="cpu").numpy(),
            np.asarray(jsw.dynamics_mask(jcfg)))

    rng = np.random.default_rng(1)
    n, k = 20, 5
    x = rng.uniform(-1, 1, size=(n, 2)).astype(dtype_name)
    v = rng.normal(size=(n, 2)).astype(dtype_name) * 0.3
    u = rng.normal(size=(n, 2)).astype(dtype_name) * 0.3
    theta = rng.uniform(-np.pi, np.pi, size=n).astype(dtype_name)
    slab = rng.uniform(-1, 1, size=(n, k, 4)).astype(dtype_name)
    mask = rng.uniform(size=(n, k)) < 0.7
    T = lambda a: torch.as_tensor(a)                         # noqa: E731
    J = jnp.asarray

    def close(got, want):
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                close(g, w)
            return
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=tol)

    close(tsw.complete_nominal(tcfg, T(u), T(x), T(v), T(slab), T(mask)),
          jsw.complete_nominal(jcfg, J(u), J(x), J(v), J(slab), J(mask)))
    close(tsw.integrate(tcfg, T(x), T(v), T(u)),
          jsw.integrate(jcfg, J(x), J(v), J(u)))
    close(tsw.separation_bias(tcfg, T(x), T(slab), T(mask)),
          jsw.separation_bias(jcfg, J(x), J(slab), J(mask)))
    close(tsw.nominal_accel(tcfg, T(u), T(v)),
          jsw.nominal_accel(jcfg, J(u), J(v)))
    pri = rng.uniform(size=(n, k)) < 0.5
    for prio in (None, pri):
        got = tsw.relax_tiers(tcfg, T(mask), None if prio is None
                              else T(prio))
        want = jsw.relax_tiers(jcfg, J(mask), None if prio is None
                               else J(prio))
        assert got[1] == want[1]
        if want[0] is None:
            assert got[0] is None
        else:
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
    if family == "unicycle":
        close(tsw.projection_points(tcfg, T(x), T(theta)),
              jsw.projection_points(jcfg, J(x), J(theta)))
        close(tsw.unicycle_apply(tcfg, T(x), T(theta), T(u) * 0.5),
              jsw.unicycle_apply(jcfg, J(x), J(theta), J(u) * 0.5))


def test_heading_spawn_is_seeded_and_its_own_stream():
    cfg = tsw.Config(n=300, dynamics="unicycle")
    a = tsw.heading_spawn(cfg, 3, device="cpu")
    assert a.shape == (300,) and a.dtype == cfg.dtype
    assert torch.equal(a, tsw.heading_spawn(cfg, 3, device="cpu"))
    assert not torch.equal(a, tsw.heading_spawn(cfg, 4, device="cpu"))
    assert float(a.min()) >= -np.pi and float(a.max()) < np.pi
    # JAX's headings bit for bit, and not the spawn jitter's stream (seed s)
    # nor seed s+1's.
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jsw.heading_spawn(jsw.Config(
            n=300, dynamics="unicycle"), 3)))
    for seed in (3, 4):
        jitter = tsw.spawn_positions(cfg, seed, device="cpu").numpy() - \
            tsw.spawn_layout(cfg)[0]
        assert not np.allclose(jitter[:, 0], a.numpy())
    state = tsw.initial_state(cfg, device="cpu")
    assert torch.equal(state.theta,
                       tsw.heading_spawn(cfg, cfg.seed, device="cpu"))


# -- the per-agent filter path ------------------------------------------------

def _per_agent_batch(rng, N=40, K=6, dtype="float64"):
    """A mixed swarm's per-agent dynamics and parameters, with random
    states and slabs; lane 0 a tight sandwich that relaxes for several
    rounds, lane 1 an empty mask."""
    jcfg = jsw.Config(n=N, dynamics="mixed", n_double=N // 2,
                      dtype=getattr(jnp, dtype))
    f, g, _ = jsw.barrier_dynamics(jcfg, jcfg.dtype)
    params = jsw.default_cbf(jcfg)
    states = rng.uniform(-0.5, 0.5, size=(N, 4)).astype(dtype)
    obs = (states[:, None, :]
           + rng.uniform(-0.3, 0.3, size=(N, K, 4))).astype(dtype)
    mask = rng.uniform(size=(N, K)) < 0.7
    u0 = rng.uniform(-1, 1, size=(N, 2)).astype(dtype)
    obs[0, :2] = states[0] + np.array([[0.02, 0, -2, 0], [-0.02, 0, 2, 0]])
    mask[0, :2] = True
    mask[1] = False
    pri = rng.uniform(size=(N, K)) < 0.5
    return (jcfg, np.asarray(f), np.asarray(g), params, states, obs, mask,
            u0, pri)


@pytest.mark.parametrize("with_priority", [False, True])
def test_per_agent_filter_matches_jax_vmap(dtype_name, with_priority):
    """f (N, 4, 4), g (N, 4, 2) and (N,) parameter leaves against JAX's
    vmap of safe_control: the full (K+8)-row assembly per lane, each lane
    its own relax loop."""
    rng = np.random.default_rng(5)
    (jcfg, f, g, jparams, states, obs, mask, u0,
     pri) = _per_agent_batch(rng, dtype=dtype_name)
    kw = dict(reference_layout=False, vel_box_rows=False)
    prio = pri if with_priority else None
    uj, ij = jfil.safe_controls(
        jnp.asarray(states), jnp.asarray(obs), jnp.asarray(mask),
        jnp.asarray(f), jnp.asarray(g), jnp.asarray(u0), jparams,
        priority_mask=None if prio is None else jnp.asarray(prio), **kw)
    tparams = convert.cbf_params_from_numpy(jparams, device="cpu",
                                            dtype=getattr(torch, dtype_name))
    T = torch.as_tensor
    ut, it = tfil.safe_controls(
        T(states), T(obs), T(mask), T(f), T(g), T(u0), tparams,
        priority_mask=None if prio is None else T(prio), **kw)
    tol = 1e-12 if dtype_name == "float64" else 1e-5
    assert ut.dtype == getattr(torch, dtype_name)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=tol)
    np.testing.assert_array_equal(it.feasible.numpy(),
                                  np.asarray(ij.feasible))
    np.testing.assert_array_equal(it.relax_rounds.numpy(),
                                  np.asarray(ij.relax_rounds))
    assert float(it.relax_rounds[0]) >= 2.0       # lane 0 relaxes
    # The per-row box: double rows clip at accel_limit.
    assert float(ut[: 20].abs().max()) <= jcfg.accel_limit + 1e-6


def test_per_agent_lanes_take_their_own_rounds(x64):
    """The batched relax gives each lane the rounds its own loop gives
    (the single-agent solve of each lane's rows), and guarded_relax with
    enough rounds gives the same bits; with too few it raises the flag."""
    rng = np.random.default_rng(7)
    (jcfg, f, g, jparams, states, obs, mask, u0,
     _) = _per_agent_batch(rng, N=24)
    # Lanes 2-5: sandwiches of growing depth, in rows relaxed at 0.01.
    for lane, gap in zip(range(2, 6), (0.05, 0.1, 0.2, 0.3)):
        obs[lane, :2] = states[lane] + np.array([[gap / 2, 0, -1, 0],
                                                 [-gap / 2, 0, 1, 0]])
        mask[lane, :2] = True
    T = torch.as_tensor
    params = convert.cbf_params_from_numpy(jparams, device="cpu",
                                           dtype=torch.float64)
    prio = torch.ones(mask.shape, dtype=torch.bool)
    args = (T(states), T(obs), T(mask), T(f), T(g), T(u0), params)
    kw = dict(reference_layout=False, vel_box_rows=False, priority_mask=prio)
    u, info = tfil.safe_controls(*args, **kw)
    rounds = info.relax_rounds.numpy()
    assert len(set(rounds[:6].tolist())) >= 3     # lanes differ
    for lane in range(24):
        p = tfil.CBFParams(*(leaf[lane] if isinstance(leaf, torch.Tensor)
                             else leaf for leaf in params))
        ul, il = tfil.safe_control(
            args[0][lane], args[1][lane], args[2][lane], args[3][lane],
            args[4][lane], args[5][lane], p, priority_mask=prio[lane],
            reference_layout=False, vel_box_rows=False)
        assert float(il.relax_rounds) == rounds[lane], lane
        np.testing.assert_allclose(ul.numpy(), u[lane].numpy(), rtol=0,
                                   atol=1e-12)
    deep = int(rounds.max())
    for guard, raised in ((deep, False), (deep - 1, True)):
        flag = torch.zeros((), dtype=torch.bool)
        with tqp.guarded_relax(guard, flag):
            ug, ig = tfil.safe_controls(*args, **kw)
        assert bool(flag) == raised
        if not raised:
            assert torch.equal(ug, u)
            assert torch.equal(ig.relax_rounds, info.relax_rounds)


# -- whole rollouts -----------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n,half", [(16, 0.25), (48, None)])
def test_family_dense_path_f64_matches_jax(x64, family, n, half):
    """gating="jnp" in float64; the packed N=16 case (spawn box 0.25 m)
    relaxes from the first step."""
    jcfg = jsw.Config(n=n, steps=20, gating="jnp", dynamics=family,
                      dtype=jnp.float64, spawn_half_width_override=half,
                      **FAMILIES[family])
    jf, jo, tf, to = _run_both(jcfg)
    _assert_rollouts_close(jf, jo, tf, to, f64=True)
    if half is not None:
        assert float(to.max_relax_rounds[0]) >= 1.0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_kernel_path_f32_matches_jax(family):
    """JAX gating="pallas" (interpret mode) against the port's "auto"
    (the kernel contract's plain version on the CPU), float32."""
    extra = {"n_double": 24} if family == "mixed" else {}
    jcfg = jsw.Config(n=64, steps=24, gating="pallas", dynamics=family,
                      **extra)
    jf, jo, tf, to = _run_both(jcfg, gating="auto")
    _assert_rollouts_close(jf, jo, tf, to, f64=False)
    assert int(to.filter_active_count.min()) > 0


def test_packed_f32_families_match_jax():
    """float32 on the packed start, where every step relaxes."""
    for family, extra in FAMILIES.items():
        jcfg = jsw.Config(n=16, steps=20, gating="jnp", dynamics=family,
                          spawn_half_width_override=0.25, **extra)
        jf, jo, tf, to = _run_both(jcfg)
        _assert_rollouts_close(jf, jo, tf, to, f64=False)


def test_state_carries_across_with_every_leaf():
    cert = dict(certificate=True, certificate_backend="sparse",
                certificate_rebuild_skin=0.1, certificate_warm_start=True)
    jcfg = jsw.Config(n=12, dynamics="unicycle", gating_rebuild_skin=0.1,
                      rta=True, **cert)
    s0, _ = jsw.make(jcfg)
    t0 = convert.state_from_reference(s0, device="cpu", dtype=torch.float32)
    assert torch.equal(t0.theta, torch.as_tensor(np.asarray(s0.theta)))
    assert [a.dtype for a in t0.gating_cache] == [
        torch.int32, torch.float32, torch.int32, torch.float32]
    assert [a.dtype for a in t0.certificate_cache] == [
        torch.int32, torch.float32, torch.int32]
    assert [a.shape for a in t0.certificate_solver_state] == [
        (24,), (132,), (24,), (132,), (24,)]
    assert [a.dtype for a in t0.rta[:4]] == [
        torch.int32, torch.int32, torch.float32, torch.float32]
    assert t0.rta[4].shape == (12,)
    seed = tsw.initial_state(tsw.Config(n=12, dynamics="unicycle",
                                        gating_rebuild_skin=0.1, rta=True,
                                        **cert), device="cpu")
    for got, want in zip(teng._leaves(t0), teng._leaves(seed)):
        assert got.shape == want.shape and got.dtype == want.dtype
    # The certificate's carries are the port's own seeds, value for value.
    for got, want in zip(t0.certificate_cache + t0.certificate_solver_state,
                         seed.certificate_cache
                         + seed.certificate_solver_state):
        assert torch.equal(got, want)
