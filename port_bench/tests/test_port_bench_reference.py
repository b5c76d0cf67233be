"""The plain reference against the port on the CPU, one step at a time
from the port's own states: a 64-agent swarm, and the certificate at
N=256. And the control: the reference in bfloat16 is not taken for the
float32 program."""

import pytest
import torch

from port_bench.reference import swarm as ref


def _port_run(n, steps, certificate=False):
    from cbf_tpu_torch.rollout import engine
    from cbf_tpu_torch.scenarios import swarm

    cfg = swarm.Config(n=n, certificate=certificate, record_trajectory=True)
    state0, step = swarm.make(cfg, device="cpu")
    final, outs = engine.eager_rollout(step, state0, steps)
    xs = torch.cat([outs.trajectory, final.x[None]])
    fields = {"n": n, "certificate": certificate, "record_trajectory": True}
    return cfg, xs, outs, ref.from_config({"swarm": fields})


def _one_step(cfg, xs, t, p, dtype=torch.float32):
    v = (torch.zeros_like(xs[0]) if t == 0
         else (xs[t].double() - xs[t - 1].double()) / cfg.dt)
    return ref.step(xs[t].to(dtype), v.to(dtype), p)


def test_reference_follows_the_port_swarm64():
    cfg, xs, outs, p = _port_run(64, 120)
    for t in range(120):
        o = _one_step(cfg, xs, t, p)
        assert float(torch.amax(torch.abs(o.x_new - xs[t + 1]))) < 1e-6
        assert float(torch.amin(o.nearest)) == pytest.approx(
            float(outs.min_pairwise_distance[t]), abs=1e-7)
        assert int(o.engaged.sum()) == int(outs.filter_active_count[t])
        assert int(o.dropped.sum()) == int(outs.gating_dropped_count[t])
        assert int((~o.feasible & o.engaged).sum()) == int(
            outs.infeasible_count[t])


def test_reference_follows_the_port_certificate256():
    cfg, xs, outs, p = _port_run(256, 6, certificate=True)
    for t in range(6):
        o = _one_step(cfg, xs, t, p)
        assert float(torch.amax(torch.abs(o.x_new - xs[t + 1]))) < 1e-6
        assert int(o.cert_dropped) == int(outs.certificate_dropped_count[t])
        assert float(o.cert_residual) == pytest.approx(
            float(outs.certificate_residual[t]), abs=1e-6)


def test_bfloat16_control_is_rejected_swarm64():
    """The control's widest one-step gap is far over the cells' limit,
    where the float32 reference's is far under it."""
    from port_bench import common

    limit = common.workload("swarm4096.filter")["limits"]["x_gap_m"]
    cfg, xs, _, p = _port_run(64, 60)
    worst = max(float(torch.amax(torch.abs(
        _one_step(cfg, xs, t, p, torch.bfloat16).x_new.double()
        - xs[t + 1].double()))) for t in range(60))
    assert worst > 3 * limit


def test_binding_radius():
    assert ref.binding_pair_radius(100.0, 0.12, 0.2) == pytest.approx(
        0.5706751, abs=1e-6)
