"""Time the whole table's m-round pass and the mesh's count fold of a
checkout on one card, and report their registers.

    python3 tools/time_rounds.py [--ptxas] [ROOT ...]

Each ROOT (default: this checkout) is a checkout of this repository, for
instance an older commit unpacked with ``git archive`` into a gitignored
directory. The kernels of each are built from its own sources and timed in
a process of its own, in the order given, so that two versions can be
compared on one card in one run (give them as A B B A). On each:

- ring_multiround_packed at m = 8 (#11), 1024 x 2^20, nf = 3, 2, 1: CUDA
  events around 3 calls after a warm-up (host-inclusive, the clock of
  chip_smoke.py's kernel table) and one call on the device's clock alone
  (chip_smoke.device_once); the compacting frontier's pass over all 4096
  stripes beside it (#19 at m = 8, the same stages);
- the fold of S = 4 shards' counts into the next ids array, at the
  main paths' t_total (1024 dense at m = 1 and 8; 4096 packed at m = 1
  and the window's m = 63): the whole fold host-inclusive (20 calls: a
  checkout whose compaction takes one [m, t_total] total runs the host's
  fold, a zeroed tensor, S adds (the window: S adds and S maximums) and
  the compaction; one that takes the shards' rows runs its one launch),
  the compaction's device time alone, and the card's launch floor (an
  empty kernel, a spin of zero cycles, on the same clock);
- launches per mesh step: small sharded sims on the card (4 shards of
  64 x 8192, dense lww on the fused frontier and packed on the window
  route), a cutoff converge each with its PyTorch operators counted: the
  port's kernel launches (``_build.LAUNCHES``) and the operators that
  launch kernels, per fold.

``--ptxas`` first compiles packed_round.cu, compact_counts.cu and
frontier_packed.cu of each ROOT with ``-Xptxas -v`` and prints the
registers, shared memory and spills of every kernel. Prints the card's
name and power limit first, then lines ``TIME <root> <what>: <ms> ms``
and ``STEP <root> <what>: ...``.
"""

from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys
import tempfile

from time_frontiers import ptxas_lines

PTXAS_SOURCES = ("packed_round.cu", "compact_counts.cu", "frontier_packed.cu")
SHARDS = 4
# the PyTorch operators that launch a kernel of their own (views and empty
# allocations launch none)
LAUNCHING = ("zeros", "zero_", "fill_", "add", "add_", "maximum", "copy_", "_to_copy",
             "index_put_", "new_zeros", "cat", "nonzero")
FOLDS = ("compact_counts", "compact_counts fused", "compact_counts window")


def ptxas_report(root: str) -> None:
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


def op_counter():
    """A dispatch mode whose ``counts`` tally the PyTorch operators run
    under it, by name."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    return Count()


def time_root(root: str) -> None:
    """Times and counts of ``root`` (see the module docstring); run in a
    process of its own."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from bullet_tpu_torch import PeerNetworkSim, _build
    from bullet_tpu_torch.ops import packed as pk
    from bullet_tpu_torch.ops.ring_kernel import frontier_tile_n

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    dev = torch.device("cuda", 0)
    _build.library()
    res = {}
    p, n = 1024, 1 << 20
    tile = frontier_tile_n(n)
    every = np.ones(n // tile, bool)
    for nf in (3, 2, 1):
        table = cs.random_family(nf, 5 + nf, p, n, dev)
        res[f"ring_multiround_packed nf={nf} m=8"] = cs.time_ms(
            lambda: pk.ring_multiround_packed(table, True, 8), 3)
        res[f"ring_multiround_packed nf={nf} m=8 device"] = cs.device_once(
            lambda: pk.ring_multiround_packed(table, True, 8))[1]
        ids = cs._ids(every, 8, dev)
        res[f"frontier_round_packed nf={nf} m=8"] = cs.time_ms(
            lambda: pk.frontier_round_packed(table, ids, tile, True, 8), 3)
        del table
        torch.cuda.empty_cache()

    one_launch = "out" in inspect.signature(pk.compact_counts).parameters
    rng = np.random.default_rng(3)
    for t_total, m, window in ((1024, 1, False), (1024, 8, False), (4096, 1, False),
                               (4096, 63, True)):
        rows = 2 if window else m
        draw = lambda: torch.from_numpy(  # noqa: E731
            rng.integers(0, 3, (SHARDS, rows, t_total)).astype(np.int32)).to(dev)
        shards = draw()
        if one_launch:
            out = torch.empty(t_total + 3, dtype=torch.int32, device=dev)
            fold = ((lambda c: pk.compact_counts_window(c, m, out)) if window
                    else (lambda c: pk.compact_counts(c, out)))
            whole = lambda: fold(shards)  # noqa: E731
            alone = lambda c: fold(c)  # noqa: E731
        else:
            def whole():
                total = torch.zeros((rows, t_total), dtype=torch.int32, device=dev)
                for s in range(SHARDS):
                    if window:
                        total[0] += shards[s][0]
                        total[1] = torch.maximum(total[1], shards[s][1])
                    else:
                        total = total + shards[s]
                return pk.compact_counts_window(total, m) if window else pk.compact_counts(total)
            alone = ((lambda c: pk.compact_counts_window(c[0], m)) if window
                     else (lambda c: pk.compact_counts(c[0])))
        what = f"fold S={SHARDS} t_total={t_total} {'window m=63' if window else f'm={m}'}"
        res[f"{what} host-inclusive"] = cs.time_ms(whole, 20)
        fresh = draw()
        res[f"{what} compaction device"] = cs.device_once(lambda: alone(fresh))[1]
    res["launch floor device"] = cs.device_once(lambda: torch.cuda._sleep(0))[1]
    for name, ms in res.items():
        print(f"TIME {root} {name}: {ms:.4f} ms", flush=True)

    for layout, extra, max_rounds in (("dense", dict(mode="lww"), 12), ("packed", {}, 70)):
        sim = PeerNetworkSim(64, capacity=8192, topology="ring", layout=layout, device=dev,
                             mesh_devices=[dev] * SHARDS, use_shard_map=True, **extra)
        slots = sim.host.intern_batch([f"k/{i}" for i in range(8000)])
        k = 1 << 14
        sim.put_bulk(rng.integers(0, 64, k).astype(np.int32), slots[rng.integers(0, 8000, k)],
                     rng.integers(-500, 500, k))
        sim.step(0)
        before = dict(_build.LAUNCHES)
        counter = op_counter()
        with counter:
            rounds = sim.run_until_converged(max_rounds=max_rounds)
        kernels = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        steps = sum(kernels.get(k, 0) for k in FOLDS)
        ops = {k: v for k, v in sorted(counter.counts.items()) if k in LAUNCHING}
        print(f"STEP {root} {layout} [{sim._convergence_strategy()[0]}] {rounds} rounds, "
              f"{steps} mesh steps: port kernels {kernels}; launching PyTorch operators {ops}; "
              f"per step {sum(ops.values()) / max(steps, 1):.2f} operators and "
              f"{sum(kernels.values()) / max(steps, 1):.2f} port kernels", flush=True)
        del sim
        torch.cuda.empty_cache()


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
