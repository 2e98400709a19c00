"""Readings for the limits of ``correct``: many seeds of one cell in one
process, each a whole run (set-up, window, check), sound or as the control.

    python3 perfbench/readings.py --workload <cell> --seeds <n,n,...> --seconds <s>
                                  [--control cutoff] [--trace 0|1]

Prints one JSON line a seed: the seed, ``correct``, the checks and the
metrics. The benchmark's own runs never run this; set-up after the first
seed is shorter than a fresh process's, so its ``setup_s`` is not one.
Needs a CUDA card, or one a shard of a sharded configuration (one process
a card, as ``run.py``).
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from perfbench import launch

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=("cutoff",))
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    launch.add_arguments(ap)
    args = ap.parse_args(argv)
    if args.rank is not None:
        launch.die_with_parent()
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("readings.py: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.Cell(ROOT, args.workload)
    if torch.cuda.device_count() < spec.cell["chips"]:
        print(f"readings.py: {torch.cuda.device_count()} cards, the cell asks for "
              f"{spec.cell['chips']}", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def body(device):
        for seed in (int(s) for s in args.seeds.split(",")):
            with contextlib.redirect_stdout(sys.stderr):
                res = harness.run_cell(ROOT, args.workload, seed, args.seconds, bool(args.trace),
                                       device=device, control=args.control, log=log)
            if res is None:  # a worker
                continue
            harness.log_checks(res, log)
            print(json.dumps({"seed": seed, "control": args.control, "correct": res["correct"],
                              "failed": res["failed"], "attempted": res["attempted"],
                              "checks": res["checks"], "metrics": res["metrics"],
                              "device": res["device"]}), flush=True)

    launch.spmd(args, argv, __file__, launch.world(ROOT, args.workload), "cuda", "nccl", body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
