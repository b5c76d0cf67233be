"""Side-by-side comparison of the swarm's three dynamics families
(counterpart: examples/dynamics_families.py).

The reference demonstrates one robot model (single-integrator commands on
Robotarium unicycles). The swarm runs three through the same CBF filter
pipeline:

- ``single``   — the reference's model, the main path;
- ``unicycle`` — the reference's actual robot at swarm scale (projection-
  point filtering + wheel-saturated integration);
- ``double``   — acceleration control with exact discrete HOCBF rows.

Runs all three at the same N/seed on ``--device`` (default the card;
``cpu`` for the CPU) and writes the min-pairwise-distance time series to
``dynamics_families.csv`` in ``--out`` (default this package's
``examples/media``) plus, where matplotlib is installed, a comparison
plot ``dynamics_families.png``. The printed table reports the measured
floor, settled spacing and diagnostics per family.

Run: ``python -m cbf_tpu_torch.examples.dynamics_families [--n 64]
[--steps 500] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

MEDIA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "media")

FAMILIES = ("single", "unicycle", "double")


def main(n: int = 64, steps: int = 500, media_dir: str = MEDIA,
         device=None) -> dict:
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.scenarios import swarm

    # Euclidean floor implied by the L1 barrier at the canonical dmin.
    floor = float(CBFParams().dmin) / np.sqrt(2.0)

    os.makedirs(media_dir, exist_ok=True)
    series, summary = {}, {}
    for dyn in FAMILIES:
        cfg = swarm.Config(n=n, steps=steps, dynamics=dyn)
        _final, outs = swarm.run(cfg, device=device)
        # One host copy per family: the series and both counters.
        md, infeasible, relax = (
            t.cpu().numpy() for t in (
                outs.min_pairwise_distance,
                outs.infeasible_count.sum(),
                outs.max_relax_rounds.max()))
        series[dyn] = md
        tail = md[-max(steps // 10, 1):]
        summary[dyn] = {
            "floor": float(md.min()),
            "settled": float(tail.min()),
            "infeasible": int(infeasible),
            "max_relax": float(relax),
        }
        print(f"{dyn:9s} floor={summary[dyn]['floor']:.4f} "
              f"settled={summary[dyn]['settled']:.4f} "
              f"infeasible={summary[dyn]['infeasible']} "
              f"max_relax={summary[dyn]['max_relax']:.0f}")

    cols = np.stack([np.arange(steps)] + [series[d] for d in FAMILIES], 1)
    np.savetxt(os.path.join(media_dir, "dynamics_families.csv"), cols,
               delimiter=",", header="step," + ",".join(FAMILIES),
               comments="")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        for dyn in FAMILIES:
            ax.plot(series[dyn], label=dyn, linewidth=1.2)
        ax.axhline(floor, color="k", linestyle="--", linewidth=0.8,
                   label=f"L1 barrier floor ({floor:.4f})")
        ax.set_xlabel("step")
        ax.set_ylabel("min pairwise distance (m)")
        ax.set_title(f"Swarm dynamics families, N={n}")
        ax.legend(loc="upper right", fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(media_dir, "dynamics_families.png"),
                    dpi=110)
        plt.close(fig)
    except Exception as e:  # matplotlib optional — the CSV is the artifact
        print(f"(plot skipped: {e})", file=sys.stderr)
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=MEDIA, help="artifact directory")
    args = ap.parse_args()
    main(n=args.n, steps=args.steps, media_dir=args.out,
         device=torch.device(args.device))
