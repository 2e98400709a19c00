"""Time chip_smoke.py's in-process mesh path of one or more checkouts.

    python3 tools/time_mesh.py [ROOT ...]

Each ROOT (default: this checkout) is a checkout of this repository, for
instance an older commit unpacked with ``git archive`` into a gitignored
directory. Each runs phase 9 of its own ``chip_smoke.py`` (4 shards of the
packed and rank1 1024 x 2^20 rings on one card beside unsharded twins,
every check included) in a process of its own, with its own kernels, in
the order given, so that two versions can be compared on one card in one
run (give them as A B B A). Prints the card's name and power limit first,
then one line ``TIME <root> <window>: <s> s`` per timed window (host
clock, the device drained at both ends).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys


def time_root(root: str) -> None:
    """Phase 9 of ``root``, its windows printed; run in a process of its own."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bullet_tpu_torch import _build

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    _build.library()
    args = cs.build_parser().parse_args([])
    seen = []

    @contextlib.contextmanager
    def window(name, secs):
        with cs.wall_window(name, secs):
            yield
        seen.append((name, secs[name]))

    cs.sharded_packed_path(args, torch.device("cuda", 0), window)
    for name, s in seen:
        print(f"TIME {root} {name}: {s:.4f} s", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="*", default=["."])
    parser.add_argument("--one", help=argparse.SUPPRESS)  # a child process's root
    args = parser.parse_args()
    if args.one:
        time_root(args.one)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for root in [os.path.abspath(r) for r in args.roots]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
