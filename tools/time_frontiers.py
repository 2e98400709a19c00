"""Time the fused frontier kernels of a checkout on one card, and report
their registers.

    python3 tools/time_frontiers.py [--ptxas] [ROOT ...]

Each ROOT (default: this checkout) is a checkout of this repository, for
instance an older commit unpacked with ``git archive`` into a gitignored
directory. The kernels of each are built from its own sources and timed in
a process of its own, in the order given, so that two versions can be
compared on one card in one run (give them as A B B A). CUDA events, the
mean of 5 calls after one warm-up (3 for the shard window), on:

- frontier_round_packed (#19 at m = 8, #20 at m = 1), 1024 x 2^20, all
  4096 stripes, nf = 3, 2, 1;
- frontier_shard_window (#25, m = 63), one 256 x 2^20 shard, nf = 3, 2, 1;
- frontier_round_dense (#8, m = 8), 1024 x 2^18 (reference, lww) and lean
  1024 x 2^20;
- frontier_shard_round (#7 at m = 8, #6 at m = 1) on one shard of phase 8
  of chip_smoke.py, 256 x 2^18, with s = m boundary rows: reference, lww
  and lean;
- frontier_shard_round_packed (#23 at m = 8, #22 at m = 1) on one shard
  of phase 9, 256 x 2^20, with s = m boundary rows: nf = 3, 2, 1.

Where the checkout has the occupancy entry of the per-shard m = 1 kernel
(``bt_frontier_shard_blocks``), one line ``OCCUPANCY ...`` a field count
gives the blocks of it an SM holds. ``--ptxas`` first compiles the
frontier sources of each ROOT with ``-Xptxas -v`` and prints the
registers, shared memory and spills of every kernel. Prints the card's
name and power limit first, then one line ``TIME <root> <kernel shape>:
<ms> ms`` per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

PTXAS_SOURCES = ("frontier_packed.cu", "frontier_dense.cu", "frontier_shard.cu",
                 "frontier_shard_window.cu")


def ptxas_report(root: str) -> None:
    """Registers, shared memory and spills of the frontier kernels of ``root``."""
    sys.path.insert(0, root)
    from bullet_tpu_torch import _build

    with tempfile.TemporaryDirectory() as work:
        for src in PTXAS_SOURCES:
            out = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(_build.CSRC / src), "-o", os.path.join(work, "x.o")],
                capture_output=True, text=True)
            if out.returncode:
                raise RuntimeError(f"nvcc {src} failed:\n{out.stderr[-4000:]}")
            for line in ptxas_lines(src, out.stderr):
                print(line, flush=True)


def ptxas_lines(src: str, stderr: str):
    """``PTXAS <source> <kernel>: <usage>`` for each register, shared
    memory and spill line of ``nvcc -Xptxas -v``'s report."""
    name = ""
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            usage = line.split("ptxas info    :", 1)[-1].strip()
            yield f"PTXAS {src} {name}: {usage}"


def time_root(root: str) -> None:
    """Times of the fused frontier kernels of ``root`` (see the module
    docstring); run in a process of its own."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from bullet_tpu_torch import _build
    from bullet_tpu_torch.ops import packed as pk
    from bullet_tpu_torch.ops.ring_kernel import (
        frontier_round_dense,
        frontier_shard_round,
        frontier_tile_n,
    )

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    dev = torch.device("cuda", 0)
    lib = _build.library()
    res = {}
    p, n = 1024, 1 << 20
    tile = frontier_tile_n(n)
    if hasattr(lib, "bt_frontier_shard_blocks"):
        for nf, lww in ((7, 0), (7, 1), (4, 0), (3, 0), (2, 0), (1, 0)):
            blocks = ctypes.c_int(0)
            _build.check(lib.bt_frontier_shard_blocks(nf, lww, tile, ctypes.byref(blocks)),
                         "bt_frontier_shard_blocks")
            print(f"OCCUPANCY {root} frontier_shard m=1 nf={nf} lww={lww} tile={tile}: "
                  f"{blocks.value} blocks an SM", flush=True)
    every = np.ones(n // tile, bool)
    for nf in (3, 2, 1):
        table = cs.random_family(nf, 5 + nf, p, n, dev)
        for m in (8, 1):
            ids = cs._ids(every, m, dev)
            res[f"frontier_round_packed nf={nf} m={m}"] = cs.time_ms(
                lambda: pk.frontier_round_packed(table, ids, tile, True, m), 5)
        del table
        torch.cuda.empty_cache()
    for nf in (3, 2, 1):
        shard = cs.random_family(nf, 9 + nf, 256, n, dev)
        tops = list(cs.random_family(nf, 19 + nf, 63, n, dev))
        bottoms = list(cs.random_family(nf, 29 + nf, 63, n, dev))
        ids = cs._ids(every, 8, dev)
        res[f"frontier_shard_window nf={nf} m=63"] = cs.time_ms(
            lambda: pk.frontier_shard_window(shard, tops, bottoms, ids, tile, 63), 3)
        del shard, tops, bottoms
        torch.cuda.empty_cache()
    nd = 1 << 18
    tile_d = frontier_tile_n(nd)
    table = cs.random_table(4, p, nd, dev)
    ids = cs._ids(np.ones(nd // tile_d, bool), 8, dev)
    for mode in ("reference", "lww"):
        res[f"frontier_round_dense {mode} 1024x2^18 m=8"] = cs.time_ms(
            lambda: frontier_round_dense(table, ids, tile_d, True, mode, 8), 5)
    del table
    torch.cuda.empty_cache()
    table = cs.lean_table(5, p, n, dev)
    ids = cs._ids(every, 8, dev)
    res["frontier_round_dense lean 1024x2^20 m=8"] = cs.time_ms(
        lambda: frontier_round_dense(table, ids, tile, True, "reference", 8, lean=True), 5)
    del table
    torch.cuda.empty_cache()
    b = p // cs.SHARDS
    rng = np.random.default_rng(7)
    shard = cs.random_table(41, b, nd, dev)
    tops, bottoms = (cs._boundary(rng, 8, nd, dev, False) for _ in range(2))
    for m in (8, 1):
        ids = cs._ids(np.ones(nd // tile_d, bool), m, dev)
        for mode, nf in (("reference", 7), ("lww", 7), ("lean", 4)):
            res[f"frontier_shard {mode} {b}x2^18 m={m}"] = cs.time_ms(
                lambda: frontier_shard_round(
                    shard[:nf], [t[:m] for t in tops[:nf]], [t[:m] for t in bottoms[:nf]],
                    ids, tile_d, "lww" if mode == "lww" else "reference", m), 5)
    del shard, tops, bottoms
    torch.cuda.empty_cache()
    for nf in (3, 2, 1):
        shard = cs.random_family(nf, 9 + nf, b, n, dev)
        tops = list(cs.random_family(nf, 19 + nf, 8, n, dev))
        bottoms = list(cs.random_family(nf, 29 + nf, 8, n, dev))
        for m in (8, 1):
            ids = cs._ids(every, m, dev)
            res[f"frontier_shard_packed nf={nf} {b}x2^20 m={m}"] = cs.time_ms(
                lambda: pk.frontier_shard_round_packed(
                    shard, [t[:m] for t in tops], [t[:m] for t in bottoms], ids, tile, m), 5)
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
