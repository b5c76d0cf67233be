"""Train the safety filter's (gamma, d_min, k) against a rollout
objective (counterpart: examples/train_safety_params.py).

The closed loop — barrier rows, the unrolled QP solve, the kernels'
zero-gradient selection, the rollout — is differentiable, so the filter
parameters can be fit: minimize tracking error toward the rendezvous
pack while penalizing separations below the target. Each step is
recomputed on the backward pass (``torch.utils.checkpoint``), so
activation memory stays O(1) in the horizon. ``--certificate`` trains
through the two-layer stack (the sparse joint certificate, whose K solve
carries its implicit gradient).

Artifacts (``--out``, default this package's ``examples/media``): the
loss curve ``training_loss[_two_layer][_n<N>].csv``, and with ``--n`` the
separation floor of a plain rollout per member before and after training
(``..._floor.json``).

Run: ``python -m cbf_tpu_torch.examples.train_safety_params [--steps 40]
[--horizon 100] [--certificate] [--n N] [--device cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

MEDIA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "media")


def _eval_separation_floor(cfg, params, state0, steps: int = 60) -> float:
    """Min nearest-neighbour distance over a plain (non-differentiable)
    compiled rollout of each member under the given parameters — the
    deployed behaviour the training should improve."""
    from cbf_tpu_torch.learn.tuning import params_to_cbf
    from cbf_tpu_torch.rollout.engine import rollout
    from cbf_tpu_torch.scenarios import swarm

    ecfg = dataclasses.replace(cfg, steps=steps)
    dev = state0[0].device
    cbf = params_to_cbf(params, swarm.default_cbf(ecfg, device=dev)
                        .max_speed)
    cbf = cbf._replace(**{f: float(getattr(cbf, f))
                          for f in ("dmin", "k", "gamma")})
    floor = np.inf
    for e in range(state0[0].shape[0]):
        s0, step = swarm.make(ecfg, cbf, device=dev)
        s0 = s0._replace(x=state0[0][e], v=state0[1][e])
        _, outs = rollout(step, s0, steps)
        floor = min(floor, float(outs.min_pairwise_distance.min()))
    return floor


def main(opt_steps: int = 40, horizon: int = 100, media_dir: str = MEDIA,
         certificate: bool = False, n_agents: int | None = None,
         device=None):
    if opt_steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {opt_steps}")
    from cbf_tpu_torch.learn import TrainConfig, init_params, make_train_step
    from cbf_tpu_torch.learn.tuning import params_to_cbf
    from cbf_tpu_torch.parallel.ensemble import ensemble_initial_states
    from cbf_tpu_torch.scenarios import swarm

    # Dense spawn: spacing ~0.3 m, inside the 0.4 m gating radius, so the
    # filter engages early in the horizon (with the default spread spawn
    # the parameters get no gradient signal).
    n = n_agents if n_agents is not None else 16
    side = int(np.ceil(np.sqrt(n)))
    cfg = swarm.Config(n=n, steps=horizon, k_neighbors=4, pack_spacing=0.02,
                       spawn_half_width_override=0.15 * max(side - 1, 1),
                       certificate=certificate,
                       certificate_backend="sparse" if certificate else "auto")
    tc = TrainConfig(steps=horizon, learning_rate=3e-2)
    train_step, optimizer = make_train_step(cfg, None, tc)

    E = 2
    state0 = ensemble_initial_states(cfg, list(range(E)), device=device)
    # Start detuned, so the recovery toward the working region shows.
    params0 = init_params(gamma=0.15, dmin=0.10, k=0.5,
                          device=state0[0].device)
    params = params0
    opt_state = optimizer.init(params)

    cbf0 = params_to_cbf(params, cfg.max_speed)
    print(f"E={E}, N={cfg.n}, horizon={horizon} (checkpointed)")
    print(f"start: gamma={float(cbf0.gamma):.4f} dmin={float(cbf0.dmin):.4f} "
          f"k={float(cbf0.k):.4f}")
    losses = []
    for t in range(opt_steps):
        params, opt_state, loss = train_step(params, opt_state, *state0)
        losses.append(float(loss))
        if t % 10 == 0 or t == opt_steps - 1:
            print(f"  step {t:3d}  loss {losses[-1]:.5f}")
    cbf1 = params_to_cbf(params, cfg.max_speed)
    print(f"end:   gamma={float(cbf1.gamma):.4f} dmin={float(cbf1.dmin):.4f} "
          f"k={float(cbf1.k):.4f}")
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if not np.isfinite(losses[-1]):
        raise SystemExit("non-finite loss")
    os.makedirs(media_dir, exist_ok=True)
    base = "training_loss_two_layer" if certificate else "training_loss"
    if n_agents is not None:
        base += f"_n{n}"
    np.savetxt(os.path.join(media_dir, base + ".csv"),
               np.stack([np.arange(len(losses)), losses], 1),
               delimiter=",", header="step,loss", comments="")
    if n_agents is not None:
        floor0 = _eval_separation_floor(cfg, params0, state0)
        floor1 = _eval_separation_floor(cfg, params, state0)
        rec = {"n": n, "loss_first": losses[0], "loss_last": losses[-1],
               "separation_floor_before": floor0,
               "separation_floor_after": floor1}
        with open(os.path.join(media_dir, base + "_floor.json"), "w") as fh:
            json.dump(rec, fh, indent=2)
            fh.write("\n")
        print(f"separation floor: {floor0:.4f} -> {floor1:.4f}")
    return losses[0], losses[-1]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--certificate", action="store_true",
                   help="train through the two-layer stack (sparse backend)")
    p.add_argument("--n", type=int, default=None,
                   help="agent count (also writes the before/after "
                        "separation-floor artifact)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=MEDIA)
    a = p.parse_args()
    torch.set_grad_enabled(True)
    main(a.steps, a.horizon, a.out, certificate=a.certificate,
         n_agents=a.n, device=a.device)
