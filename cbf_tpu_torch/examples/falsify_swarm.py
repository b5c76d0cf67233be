"""Falsify a deliberately weakened swarm filter, end to end (counterpart:
examples/falsify_swarm.py).

1. weaken the filter — certify 0.16 m instead of the 0.2 m the
   separation floor assumes;
2. search for an initial-state perturbation that drives a rollout below
   the floor (random breadth, gradient descent through the rollout, CEM
   refinement — whichever finds first);
3. shrink it to the earliest violating step and the smallest scale that
   still violates, and confirm it in float64;
4. archive it to a corpus JSONL and replay it;
5. run the same budget against the default filter and watch it survive.

Run: ``python -m cbf_tpu_torch.examples.falsify_swarm [--budget 64]
[--device cpu] [--out DIR]`` (default DIR: this package's
``examples/media``). Writes ``falsify_corpus.jsonl`` there.
"""

from __future__ import annotations

import argparse
import os
import sys

MEDIA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "media")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=64,
                    help="candidate rollouts per engine")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=MEDIA, help="corpus directory")
    args = ap.parse_args(argv)

    from cbf_tpu_torch import verify as V
    from cbf_tpu_torch.core.filter import CBFParams
    from cbf_tpu_torch.scenarios import swarm

    # A 16-agent swarm that packs within the horizon, cut just short of
    # the weakened filter's unperturbed violation onset: delta = 0 is
    # safe, so the engines must actually search.
    cfg = swarm.Config(n=16, steps=140, k_neighbors=4, gating="jnp")
    weak = CBFParams(max_speed=15.0, k=0.0, dmin=0.16)
    settings = V.SearchSettings(budget=args.budget, batch=8, seed=0)

    print("== 1. falsify the weakened filter (dmin 0.2 -> 0.16) ==")
    results = V.falsify("swarm", cfg, settings=settings,
                        engines=("random", "grad", "cem"), cbf=weak,
                        device=args.device)
    for r in results:
        flag = " <- VIOLATION" if r.found else ""
        print(f"  {r.engine:6s}: margin {r.margin:+.5f} ({r.property}) "
              f"after {r.evaluated} candidates{flag}")
    found = next((r for r in results if r.found), None)
    if found is None:
        print("  no violation found — raise --budget")
        return 1

    print("== 2. shrink the counterexample ==")
    sr = V.shrink("swarm", cfg, found.delta, cbf=weak, settings=settings,
                  device=args.device)
    print(f"  earliest violating step {sr.earliest_step} "
          f"(horizon {cfg.steps} -> {sr.steps}), scale {sr.scale:.3f}")
    print(f"  margin {sr.margin:+.6f}, float64 {sr.margin_x64:+.6f}, "
          f"confirmed_x64={sr.confirmed_x64}")

    print("== 3. archive + replay ==")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "falsify_corpus.jsonl")
    if os.path.exists(path):
        os.remove(path)
    entry = V.entry_from("swarm", cfg, sr, engine=found.engine,
                         settings=settings, cbf=weak)
    V.append_entry(path, entry)
    (e, replay, problems), = V.replay_corpus(path, device=args.device)
    print(f"  replayed margin {replay['margin']:+.6f} == recorded "
          f"{e['margin_x64']:+.6f}: {replay['margin'] == e['margin_x64']}")
    if problems:
        raise SystemExit(f"replay problems: {problems}")

    print("== 4. the default filter survives the same budget ==")
    r = V.random_search(V.make_adapter("swarm", cfg, device=args.device),
                        settings)
    print(f"  default: margin {r.margin:+.5f} ({r.property}) after "
          f"{r.evaluated} candidates — found={r.found}")
    if r.found:
        raise SystemExit("the default filter was falsified")
    print(f"corpus written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
