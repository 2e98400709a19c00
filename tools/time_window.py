"""Time the window join of a checkout on one card, and report its registers.

    python3 tools/time_window.py [--ptxas] [ROOT ...]

Each ROOT (default: this checkout) is a checkout of this repository, for
instance an older commit unpacked with ``git archive`` into a gitignored
directory. The kernels of each are built from its own sources and timed in
a process of its own, in the order given, so that two versions can be
compared on one card in one run (give them as A B B A). CUDA events, the
mean of 3 calls after one warm-up, on:

- ring_window_packed (#12), 1024 x 2^20 ring, nf = 3, 2, 1, at m = 120,
  480, 513 and 1024 (the main paths' depths);
- ring_window_shardmap_packed, the spmd fast_forward's window, on 4 shards
  of 256 x 2^20 on the one card (rank1 and packed), at the passes of
  fast_forward(480): m = 256 and 224, slab exchange included;
- where the checkout has it, ring_window_shard_packed (the kernel's shard
  form, #17) on one 256 x 2^20 shard at m = 256 and 224, nf = 3, 2, 1.

``--ptxas`` first compiles ``window_packed.cu`` of each ROOT with
``-Xptxas -v`` and prints the registers, shared memory and spills of each
kernel. Prints the card's name and power limit first, then one line
``TIME <root> <kernel shape>: <ms> ms`` per shape.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

from time_frontiers import ptxas_lines


def ptxas_report(root: str) -> None:
    """Registers, shared memory and spills of the window kernels of ``root``."""
    sys.path.insert(0, root)
    from bullet_tpu_torch import _build

    with tempfile.TemporaryDirectory() as work:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / "window_packed.cu"), "-o", os.path.join(work, "x.o")],
            capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc window_packed.cu failed:\n{out.stderr[-4000:]}")
        for line in ptxas_lines("window_packed.cu", out.stderr):
            print(line, flush=True)


def time_root(root: str) -> None:
    """Times of the window joins of ``root`` (see the module docstring);
    run in a process of its own."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bullet_tpu_torch import _build
    from bullet_tpu_torch.ops import packed as pk
    from bullet_tpu_torch.parallel import shardmap_gossip as sg
    from bullet_tpu_torch.parallel.mesh import ShardedTable

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    dev = torch.device("cuda", 0)
    _build.library()
    res = {}
    p, n = 1024, 1 << 20
    for nf in (3, 2, 1):
        table = cs.random_family(nf, 5 + nf, p, n, dev)
        for m in (120, 480, 513, 1024):
            res[f"window_packed nf={nf} {p}x2^20 m={m}"] = cs.time_ms(
                lambda: pk.ring_window_packed(table, True, m), 3)
        del table
        torch.cuda.empty_cache()
    b = p // cs.SHARDS
    for nf in (1, 3):
        shards = [cs.random_family(nf, 40 + i, b, n, dev) for i in range(cs.SHARDS)]
        table = ShardedTable(shards, [dev] * cs.SHARDS)
        for m in (256, 224):
            res[f"ring_window_shardmap_packed nf={nf} {cs.SHARDS}x{b}x2^20 m={m}"] = cs.time_ms(
                lambda: sg.ring_window_shardmap_packed(table, True, m), 3)
        del shards, table
        torch.cuda.empty_cache()
    if hasattr(pk, "ring_window_shard_packed"):
        for nf in (3, 2, 1):
            shard = cs.random_family(nf, 60 + nf, b, n, dev)
            tops = list(cs.random_family(nf, 70 + nf, 256, n, dev))
            bottoms = list(cs.random_family(nf, 80 + nf, 256, n, dev))
            for m in (256, 224):
                top, bottom = [t[-m:].contiguous() for t in tops], [t[:m].contiguous()
                                                                  for t in bottoms]
                res[f"window_shard nf={nf} {b}x2^20 m={m}"] = cs.time_ms(
                    lambda: pk.ring_window_shard_packed(shard, top, bottom, m), 3)
            del shard, tops, bottoms
            torch.cuda.empty_cache()
    for name, ms in res.items():
        print(f"TIME {root} {name}: {ms:.3f} ms", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="*", default=["."])
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--one", help=argparse.SUPPRESS)  # a child process's root
    parser.add_argument("--report", help=argparse.SUPPRESS)  # a child's ptxas root
    args = parser.parse_args()
    if args.one:
        time_root(args.one)
        return 0
    if args.report:
        ptxas_report(args.report)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    roots = [os.path.abspath(r) for r in args.roots]
    if args.ptxas:
        for root in dict.fromkeys(roots):
            subprocess.run([sys.executable, __file__, "--report", root], check=True)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
