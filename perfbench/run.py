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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build caches live in the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "perfbench" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "perfbench" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    cell = harness.Cell(ROOT, args.workload).cell
    if not torch.cuda.is_available():
        print("run.py: torch.cuda.is_available() is false: no card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {torch.cuda.device_count()} cards, the cell asks for {cell['chips']}",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", t0=T0, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process holds {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
