"""The readings that the limits of ``correct`` are set from.

``python3 -m port_bench.control --workload <cell> --seeds <n> [<n> ...]
--seconds <s>`` runs the cell's window once per seed, in one process, and
prints one JSON line per seed with the compared numbers of the sound
program (``sound``) and of the control (``control``): the reference
itself, computed in bfloat16 (the precision below the configuration's
float32), put in the program's place on the same kept steps. A limit lies
above every sound reading and below every control reading. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from port_bench import common


def readings(cell_name: str, seeds, seconds: float, device: str = "cuda",
             cell: dict | None = None, config: dict | None = None):
    """Yield one record per seed: the sound and the control readings."""
    import torch

    cell = common.workload(cell_name) if cell is None else cell
    config = common.config(cell["config"]) if config is None else config
    for seed in seeds:
        runner = common.make_traffic(cell, config, int(seed),
                                    torch.device(device))
        runner.setup()
        e2e, segments = runner.window(seconds)
        runner.release()
        yield {"seed": int(seed), "segments": segments,
               "kept": len(runner.kept), "e2e": e2e,
               "sound": runner.check(),
               "control": runner.check(control=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 3
    for rec in readings(args.workload, args.seeds, args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
