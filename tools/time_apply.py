"""Time the packed-family apply kernel of a checkout on one card, five ways,
and report its registers.

    python3 tools/time_apply.py [--ptxas] [ROOT ...]

Each ROOT (default: this checkout) is a checkout of this repository, for
instance an older commit unpacked with ``git archive`` into a gitignored
directory. The kernel of each is built from its own sources and timed in a
process of its own, in the order given, so that two versions can be
compared on one card in one run (give them as A B B A). Tables as
``chip_smoke.py`` phase 3 makes them (``random_family``), 1024 peers,
nf = 3, 2, 1; ops as its ``_random_ops`` makes them (K raw ops, uniform
over the table, reduced on the host: unique (peer, slot), sorted by it).
Every call starts from the same table: the entries the ops touch are
restored between calls. Three clocks, each the median of 3 calls:

- ``host``: CUDA events around one call of ``apply_flat_packed`` with the
  card idle, as ``chip_smoke.py`` timed it before: the Python wrapper's
  enqueue time is inside;
- ``dev``: the same call, but a spin kernel (``torch.cuda._sleep``) queued
  first, so the events see only the device's work (the count's zero fill
  and the kernel);
- ``raw``: the kernel alone, its C entry called with a zeroed count, a
  spin kernel queued first.

Before every timed call a 256 MB write flushes the card's 50 MB L2, so
that no entry the ops touch is cached, as on the main path (whose apply
follows work over the whole table); without it the restore of the last
call leaves up to 29 MB of them in L2 (rank1 at K = 2^20).

Shapes: the K sweep (K raw = 2^10, 2^14, 2^17, 2^20) at 1024 x 2^20, a
second call on the first's result, the ops shuffled, tables of 2^18, 2^20
and 2^22 columns at K raw = 2^20, and two yardsticks on the same ops: a
gather of the NF entries (``index_select`` on each flattened field) and,
for rank1, ``scatter_reduce_(..., "amax")`` of the ranks (the table result
without the count; the port never calls it). Each line gives K (unique
ops) and the ops that land; ``chip_smoke.py`` gives the bound.

``--ptxas`` first compiles ``apply_packed.cu`` of each ROOT with ``-Xptxas
-v``. Prints the card's name and power limit first, then one line ``TIME
<root> <shape>: ...`` per shape.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile

from time_frontiers import ptxas_lines

# The spin-and-flush timer below repeats chip_smoke.device_once on purpose:
# this tool also times older checkouts, whose chip_smoke.py has no
# device_once, and must not depend on the checkout it runs from.
# a spin of about 3 ms at the H100's clock: longer than the wrapper's enqueue
SPIN_CYCLES = 5_000_000
REPS = 3
# a write this large leaves none of the table's entries in the 50 MB L2
FLUSH_BYTES = 256 << 20


def ptxas_report(root: str) -> None:
    """Registers and spills of the apply kernels of ``root``."""
    sys.path.insert(0, root)
    from bullet_tpu_torch import _build

    with tempfile.TemporaryDirectory() as work:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / "apply_packed.cu"), "-o", os.path.join(work, "x.o")],
            capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc apply_packed.cu failed:\n{out.stderr[-4000:]}")
        for line in ptxas_lines("apply_packed.cu", out.stderr):
            print(line, flush=True)


def time_root(root: str) -> None:
    """The apply times of ``root`` (see the module docstring); run in a
    process of its own."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from bullet_tpu_torch import _build
    from bullet_tpu_torch.ops.packed import apply_flat_packed, packed_beats, op_present

    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    dev = torch.device("cuda", 0)
    lib = _build.library()
    p = 1024

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def events(fn, spin: bool) -> float:
        flush.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def case(name, table, ops, yard=False):
        """Times of applying ``ops`` to ``table`` by the three clocks, each
        call on the table as it was before the first."""
        nf = len(table)
        n = table[0].shape[1]
        planes = [f.view(-1) for f in table]
        peer, slot = ops[0].long(), ops[1].long()
        inside = (peer >= 0) & (peer < p) & (slot >= 0) & (slot < n)
        flat = (peer * n + slot)[inside]
        saved = [pl[flat].clone() for pl in planes]
        vals = [v[inside] for v in ops[2:]]
        wins_mask = packed_beats(vals, saved) & op_present(vals)
        k = ops.shape[1]
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        ptrs = _build.pointers(table)
        stream = _build.stream_of(dev)

        def put_back():
            for pl, s in zip(planes, saved):
                pl.index_copy_(0, flat, s)

        def raw():
            count.zero_()
            torch.cuda.synchronize()
            return events(lambda: lib.bt_apply_packed(ptrs, ops.data_ptr(), k, p, n,
                                                      count.data_ptr(), nf, stream), True)

        res = {}
        for clock, fn in (("host", lambda: events(lambda: apply_flat_packed(table, ops), False)),
                          ("dev", lambda: events(lambda: apply_flat_packed(table, ops), True)),
                          ("raw", raw)):
            runs = []
            for _ in range(REPS):
                runs.append(fn())
                put_back()
            res[clock] = statistics.median(runs)
        line = (f"K={k} land={int(wins_mask.sum())} "
                + " ".join(f"{c}={v:.4f}" for c, v in res.items()))
        if yard:
            gather = statistics.median(
                events(lambda: [pl.index_select(0, flat) for pl in planes], True)
                for _ in range(REPS))
            line += f" gather={gather:.4f}"
            if nf == 1:
                runs = []
                for _ in range(REPS):
                    runs.append(events(lambda: planes[0].scatter_reduce_(
                        0, flat, vals[0], "amax"), True))
                    put_back()
                line += f" scatter_amax={statistics.median(runs):.4f}"
        print(f"TIME {root} {name}: {line} ms", flush=True)

    for nf in (3, 2, 1):
        rng = np.random.default_rng(40 + nf)
        for cols in (1 << 20, 1 << 18, 1 << 22):
            table = cs.random_family(nf, 5, p, cols, dev)
            shape = f"nf={nf} {p}x2^{cols.bit_length() - 1}"
            # warm up the kernel and the wrapper on a small table
            small = cs.random_family(nf, 6, 8, 4096, dev)
            apply_flat_packed(small, cs._random_ops(rng, 8, 4096, 64, dev, nf))
            ops = cs._random_ops(rng, p, cols, 1 << 20, dev, nf)
            case(f"{shape} K=2^20 sorted", table, ops, yard=True)
            perm = torch.from_numpy(rng.permutation(ops.shape[1])).to(dev)
            case(f"{shape} K=2^20 shuffled", table, ops[:, perm].contiguous(), yard=True)
            if cols == 1 << 20:
                apply_flat_packed(table, ops)  # nothing lands a second time
                case(f"{shape} K=2^20 second call", table, ops)
                for log_k in (10, 14, 17):
                    case(f"{shape} K=2^{log_k} sorted", table,
                         cs._random_ops(rng, p, cols, 1 << log_k, dev, nf))
            del table, ops
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
