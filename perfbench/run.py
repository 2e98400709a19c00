"""Run one cell of the benchmark of bullet_tpu_torch on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the plain reference beside its limit. The same checks end standard error.
Exits non-zero with no result line when there is no CUDA card, fewer than
the cell asks for, or when the process holds JAX or the JAX package after
the window.

A sharded configuration (``shards`` above 1) runs in one process a card:
this process is rank 0 and starts the others itself (``launch.py``); only
rank 0 prints.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    from perfbench import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    launch.add_arguments(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    # one host thread for the program's CPU work, set before numpy and torch
    # load: a cell's runs spread about half as widely (PERF.md, section 2)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if args.rank is not None:
        from perfbench import launch

        launch.die_with_parent()
    # build caches live in the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "perfbench" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "perfbench" / "torch_extensions"))

    def cards() -> None:
        import torch

        from perfbench import harness

        cell = harness.Cell(ROOT, args.workload).cell
        if not torch.cuda.is_available():
            print("run.py: torch.cuda.is_available() is false: no card", file=sys.stderr)
            raise SystemExit(2)
        if torch.cuda.device_count() < cell["chips"]:
            print(f"run.py: {torch.cuda.device_count()} cards, the cell asks for {cell['chips']}",
                  file=sys.stderr)
            raise SystemExit(2)

    return serve(args, argv, __file__, "cuda", "nccl", ready=cards)


def serve(args, argv, script: str, device_type: str, backend: str, ready=lambda: None) -> int:
    """Runs the cell on ``device_type``: in this process, or, for a sharded
    configuration, in one process a shard joined by ``backend``, this one
    rank 0 (``launch.spmd``, which calls ``ready`` in rank 0 once the
    workers have started). Rank 0 prints the result; a worker prints
    nothing on standard output."""
    from perfbench import launch

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def body(device):
        from perfbench import harness

        with contextlib.redirect_stdout(sys.stderr):
            return harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                    bool(args.trace), device=device, t0=T0, log=log)

    result = launch.spmd(args, argv, script, launch.world(ROOT, args.workload), device_type,
                         backend, body, ready)
    from perfbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process holds {found}", file=sys.stderr)
        return 3
    if result is None:  # a worker
        return 0
    harness.log_checks(result, log)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
