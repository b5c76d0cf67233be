"""The port's joint barrier certificate (cbf_tpu_torch.sim.certificates
and the certificate block of cbf_tpu_torch.scenarios.swarm) against the
JAX package's, on the same numpy inputs made from a seed; the solvers
under it are held in tests/test_torch_admm.py.

Tolerances and why (float32 throughout): solutions atol 1e-5 (the two
packages sum in other orders, tests/test_torch_admm.py); swarm rollouts
positions and velocities atol 1e-5, min distance rtol 1e-6 (as
tests/test_torch_swarm.py), the certificate residual 1e-6; every count
exact: the neighbour search's (idx, mask, count), the dropped count, the
iterations of the adaptive budget, every StepOutputs count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbf_tpu.rollout import engine as jeng
from cbf_tpu.scenarios import swarm as jsw
from cbf_tpu.sim import certificates as jcert
from cbf_tpu_torch import convert
from cbf_tpu_torch.rollout import engine as teng
from cbf_tpu_torch.scenarios import swarm as tsw
from cbf_tpu_torch.sim import certificates as tcert

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


# -- the sparse certificate --------------------------------------------------

def test_sparse_search_and_certificate_match_jax():
    """The search (idx, mask, count) and the coverage gap equal JAX's, both
    forms: the kernels (plain versions here) against JAX's interpret-mode
    Pallas kernel, the dense form against JAX's jnp form; then the
    certificate itself."""
    rng = np.random.default_rng(3)
    N, k = 96, 8
    x = rng.uniform(-1.0, 1.0, (2, N))
    dxi = rng.normal(0, 0.3, (2, N))
    xj, dj = jnp.asarray(x, jnp.float32), jnp.asarray(dxi, jnp.float32)
    xt, dt = (torch.as_tensor(x, dtype=torch.float32),
              torch.as_tensor(dxi, dtype=torch.float32))
    pr = jcert.binding_pair_radius(jcert.CertificateParams())
    assert tcert.binding_pair_radius(tcert.CertificateParams()) == pr
    for kernel in (True, False):
        want = jcert._exact_search(xj.T, k, pr, kernel, True)
        got = tcert._exact_search(xt.T.contiguous(), k, pr, kernel)
        for name, a, b in zip(("idx", "mask", "count"), got, want):
            assert a.dtype in (torch.int32, torch.bool), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} kernel={kernel}")
        assert int(tcert._slot_coverage_gap(*got, N, k)) == int(
            jcert._slot_coverage_gap(*want, N, k))
    for backend in ("auto", "jnp"):
        u_j, info_j = jcert.si_barrier_certificate_sparse(
            dj, xj, k=k, with_info=True,
            neighbor_backend="pallas" if backend == "auto" else "jnp",
            pallas_interpret=True)
        u_t, info_t = tcert.si_barrier_certificate_sparse(
            dt, xt, k=k, with_info=True, neighbor_backend=backend)
        _close(u_t, u_j, 1e-5, backend)
        assert int(info_t.dropped_count) == int(info_j.dropped_count) > 0
        assert int(info_t.iterations) == int(info_j.iterations) == 100


def test_sparse_certificate_verlet_matches_jax():
    """The certificate's Verlet cache over three calls (a rebuild, a
    cached call, a rebuild after a move past skin/2), eager and in the
    compiled body's select form: the cache leaves, the solution and the
    frozen dropped count equal JAX's (its jnp search; the kernels' search
    is held to it above)."""
    from cbf_tpu_torch.solvers import exact2d

    rng = np.random.default_rng(11)
    N, k, skin = 80, 8, 0.1
    x0 = rng.uniform(-0.9, 0.9, (2, N))
    dxi = rng.normal(0, 0.3, (2, N))
    moves = [np.zeros((2, N)), np.full((2, N), 0.01),
             np.full((2, N), 0.08)]
    jc = jcert.certificate_cache_seed(N, k)
    tc = tcert.certificate_cache_seed(N, k)
    sc = tcert.certificate_cache_seed(N, k)
    for step, move in enumerate(moves):
        x = x0 + move
        xj, xt = jnp.asarray(x, jnp.float32), torch.as_tensor(
            x, dtype=torch.float32)
        dj, dt = jnp.asarray(dxi, jnp.float32), torch.as_tensor(
            dxi, dtype=torch.float32)
        u_j, info_j, jc = jcert.si_barrier_certificate_sparse(
            dj, xj, k=k, with_info=True, rebuild_skin=skin,
            neighbor_cache=jc, neighbor_backend="jnp")
        u_t, info_t, tc = tcert.si_barrier_certificate_sparse(
            dt, xt, k=k, with_info=True, rebuild_skin=skin,
            neighbor_cache=tc)
        with exact2d.guarded_relax(0, torch.zeros((), dtype=torch.bool)):
            u_s, info_s, sc = tcert.si_barrier_certificate_sparse(
                dt, xt, k=k, with_info=True, rebuild_skin=skin,
                neighbor_cache=sc)
        for a, b, s in zip(tc, jc, sc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert torch.equal(a, s), step
        assert torch.equal(u_s, u_t)
        _close(u_t, u_j, 1e-5, f"step {step}")
        assert int(info_t.dropped_count) == int(info_j.dropped_count)


def test_sparse_certificate_batched_matches_jax():
    rng = np.random.default_rng(5)
    E, N, k = 2, 48, 8
    x = rng.uniform(-0.8, 0.8, (E, 2, N))
    dxi = rng.normal(0, 0.3, (E, 2, N))
    kw = dict(k=k, with_info=True)
    u_j, info_j = jcert.si_barrier_certificate_sparse_batched(
        jnp.asarray(dxi, jnp.float32), jnp.asarray(x, jnp.float32),
        neighbor_backend="jnp", **kw)
    u_t, info_t = tcert.si_barrier_certificate_sparse_batched(
        torch.as_tensor(dxi, dtype=torch.float32),
        torch.as_tensor(x, dtype=torch.float32), neighbor_backend="jnp",
        **kw)
    _close(u_t, u_j, 1e-5)
    np.testing.assert_array_equal(info_t.dropped_count.numpy(),
                                  np.asarray(info_j.dropped_count))
    np.testing.assert_array_equal(info_t.iterations.numpy(),
                                  np.asarray(info_j.iterations))


def test_sanitize_solver_state_resets_a_poisoned_carry():
    rng = np.random.default_rng(9)
    leaves = [rng.normal(size=n) for n in (8, 20, 8, 20, 8)]
    clean = tuple(torch.as_tensor(a) for a in leaves)
    got, reset = tcert.sanitize_solver_state(clean)
    want, jreset = jcert.sanitize_solver_state(
        tuple(jnp.asarray(a) for a in leaves))
    assert not bool(reset) and not bool(jreset)
    assert all(torch.equal(a, b) for a, b in zip(got, clean))
    for bad in (np.nan, np.inf):
        leaves[3][5] = bad
        got, reset = tcert.sanitize_solver_state(
            tuple(torch.as_tensor(a) for a in leaves))
        want, jreset = jcert.sanitize_solver_state(
            tuple(jnp.asarray(a) for a in leaves))
        assert bool(reset) and bool(jreset) and reset.shape == ()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert not bool(a.any())
    empty, reset = tcert.sanitize_solver_state(())
    assert empty == () and not bool(reset)


# -- the swarm step -----------------------------------------------------------

def _port_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = np.dtype(fields["dtype"]).name
    return convert.config_from_fields(fields)


# Packed spawns (spawn_half_width_override) so the certificate binds.
SWARM_CASES = {
    "dense": dict(n=32, spawn_half_width_override=0.6),
    "sparse 64": dict(n=64, certificate_backend="sparse",
                      spawn_half_width_override=0.8),
    "sparse 128": dict(n=128, certificate_backend="sparse",
                       spawn_half_width_override=1.1),
    "unicycle": dict(n=32, dynamics="unicycle",
                     spawn_half_width_override=0.6),
    "rta": dict(n=32, rta=True, spawn_half_width_override=0.6),
    "skin": dict(n=64, certificate_backend="sparse",
                 certificate_rebuild_skin=0.1, certificate_fused=True,
                 spawn_half_width_override=0.8),
    "warm tol": dict(n=64, certificate_backend="sparse",
                     certificate_warm_start=True, certificate_tol=1e-5,
                     spawn_half_width_override=0.8),
}
CERT_FIELDS = ("certificate_residual", "certificate_dropped_count",
               "certificate_iterations", "certificate_carry_resets")
COUNTS = ("filter_active_count", "infeasible_count", "gating_dropped_count",
          "max_relax_rounds", "certificate_dropped_count",
          "certificate_iterations", "certificate_carry_resets", "rta_mode")


@pytest.mark.parametrize("case", sorted(SWARM_CASES))
def test_swarm_certificate_rollout_matches_jax(case):
    jcfg = jsw.Config(steps=6, certificate=True, **SWARM_CASES[case])
    s0, jstep = jsw.make(jcfg)
    jf, jo = jeng.rollout(jstep, s0, jcfg.steps)
    tcfg = _port_config(jcfg)
    _, tstep = tsw.make(tcfg, device="cpu")
    ts0 = convert.state_from_reference(s0, device="cpu", dtype=tcfg.dtype)
    tf, to = teng.rollout(tstep, ts0, tcfg.steps)
    for name in COUNTS:
        a, b = getattr(to, name), getattr(jo, name)
        if isinstance(b, tuple):
            assert a == (), name
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    for name in CERT_FIELDS[:3]:
        assert getattr(to, name).shape == (tcfg.steps,), name
    assert float(to.certificate_residual.max()) < 1e-4
    _close(to.certificate_residual, jo.certificate_residual, 1e-6)
    np.testing.assert_allclose(to.min_pairwise_distance.numpy(),
                               np.asarray(jo.min_pairwise_distance),
                               rtol=1e-6)
    _close(tf.x, jf.x, 1e-5, "x")
    _close(tf.v, jf.v, 1e-5, "v")
    for a, b in zip(teng._leaves(tf), _jax_leaves(jf)):
        assert tuple(a.shape) == tuple(np.shape(b))
    # The certificate binds: without it the run goes elsewhere.
    plain = _port_config(jsw.Config(
        steps=6, **{name: value for name, value in SWARM_CASES[case].items()
                    if not name.startswith("certificate")}))
    pf, _ = teng.rollout(tsw.make(plain, device="cpu")[1],
                         ts0._replace(certificate_cache=(),
                                      certificate_solver_state=()),
                         plain.steps)
    assert float(torch.amax(torch.abs(pf.x - tf.x))) > 1e-4


def _jax_leaves(state):
    """The tensor leaves of a JAX state, in field order ('()' skipped)."""
    out = []

    def walk(v):
        if isinstance(v, tuple):
            for w in v:
                walk(w)
        else:
            out.append(v)
    walk(tuple(state))
    return out


def test_batched_certificate_needs_the_sparse_backend():
    cfg = tsw.Config(n=16, certificate=True)
    u = torch.zeros((1, 16, 2))
    with pytest.raises(ValueError, match="sparse-backend only"):
        tsw.apply_certificate_batched(cfg, u, u)
