#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (bullet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--peers P] [--capacity N] [--ops K]
                          [--packed-capacity N] [--packed-ops K]
                          [--rank1-capacity N] [--rank1-ops K]

Phases, in order; any failure raises and exits nonzero:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the kernels of bullet_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, bit-identical (tolerance: exact, the path is all int32), at
   small and ragged shapes, at P = 4096 (where the TPU took its peer-tile
   kernels) and at the main-path shapes, with times per call there; the
   packed-family kernels at each field count (packed, rank, rank1), the
   window join also at rank1 8192 x 2^18 (the TPU's halo-window shape);
   then small dense, packed, rank and rank1 sims on the card against the
   same sims on the CPU;
4. dense main path: a dense ring PeerNetworkSim at P x N (default
   1024 x 2^18): put_bulk + scalar puts, step, run_until_converged,
   tables_equal, the converged row against an independent numpy lexmax,
   get/get_bulk, more writes applied by step(0), reconcile against a twin
   restored from a snapshot that converges;
5. packed main path: a packed ring PeerNetworkSim at P x N (default
   1024 x 2^20, 12 B/entry, 12.9 GB): put_bulk + string puts, step(1),
   run_until_converged on the packed-frontier-local route, tables_equal
   and the converged row against an independent numpy per-leaf max, an
   incremental converge after a second batch, converged(), a third batch
   and reconcile against a twin restored from a snapshot that reaches the
   fixed point by a blind fast_forward (the window kernel), get/get_bulk;
6. rank1 main path: a rank1 ring PeerNetworkSim at P x N (default
   1024 x 2^20, 4 B/entry, 4.3 GB): put_bulk + string puts, step(1), a
   snapshot restored into two twins, run_until_converged on the
   packed-frontier-local route against an independent numpy per-leaf max,
   fast_forward(480) on one twin against step(480) on the other, the
   jumped twin fast-forwarded to the fixed point against the converged
   table, then more writes, reconcile, converged() and reads; it prints
   the windowed logical merges/s of fast_forward(480), 2 P N 480 / s.

Every kernel's launch count over the phase that drives its path (4 for
the dense kernels, 5 and 6 for the packed-family ones) must be > 0. The
last two lines are a JSON object describing the kernels and the contract
line {"ok": true, "device": {...}}. Imports nothing of JAX."""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "merge": ("bullet_tpu_torch/csrc/merge.cu", "bullet_tpu/ops/merge.py:90"),
    "ring_round": (
        "bullet_tpu_torch/csrc/ring_round.cu",
        "bullet_tpu/ops/ring_kernel.py:103; bullet_tpu/ops/ring_kernel.py:46",
    ),
    "frontier_round_dense": (
        "bullet_tpu_torch/csrc/frontier_dense.cu",
        "bullet_tpu/ops/ring_kernel.py:500",
    ),
    "apply_packed": (
        "bullet_tpu_torch/csrc/apply_packed.cu",
        "bullet_tpu/ops/packed.py:355; bullet_tpu/ops/packed.py:603",
    ),
    "packed_round": (
        "bullet_tpu_torch/csrc/packed_round.cu",
        "bullet_tpu/ops/packed.py:948; bullet_tpu/ops/packed.py:967; "
        "bullet_tpu/ops/packed.py:1286; bullet_tpu/ops/packed.py:2990",
    ),
    "reconcile_packed": (
        "bullet_tpu_torch/csrc/reconcile_packed.cu", "bullet_tpu/ops/packed.py:1333",
    ),
    "frontier_round_packed": (
        "bullet_tpu_torch/csrc/frontier_packed.cu",
        "bullet_tpu/ops/packed.py:1514; bullet_tpu/ops/packed.py:2161; "
        "bullet_tpu/ops/packed.py:1601; bullet_tpu/ops/packed.py:1758",
    ),
    "window_packed": (
        "bullet_tpu_torch/csrc/window_packed.cu",
        "bullet_tpu/ops/packed.py:1138; bullet_tpu/ops/packed.py:1969",
    ),
}
DENSE_KERNELS = ("merge", "ring_round", "frontier_round_dense")
# the packed-family kernels: phase 5 drives them at nf = 3, phase 6 at nf = 1
PACKED_KERNELS = ("apply_packed", "packed_round", "reconcile_packed", "frontier_round_packed",
                  "window_packed")

# the card's peaks, from the published H100 SXM figures: HBM3 bandwidth and
# the float32 rate outside the tensor cores, which bounds these int32
# compares and selects
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for the bytes the function must
    move and the operations it must do, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def log(msg: str) -> None:
    print(msg, flush=True)


BASE_N = 4096


def tiled(blocks, n: int, device):
    """[p, n] int32 tensors from [p, min(n, BASE_N)] numpy blocks: a wider
    table repeats each block along the slot axis on the device with its
    rows rotated by the block's index, so that blocks fewer than p apart
    hold different columns and a kernel that addresses the wrong block
    cannot match its plain version."""
    fields = []
    for a in blocks:
        a = torch.from_numpy(a.astype(np.int32)).to(device)
        p, w = a.shape
        reps = -(-n // w)
        out = torch.empty((p, reps * w), dtype=torch.int32, device=device)
        for r in range(reps):
            out[:, r * w:(r + 1) * w] = torch.roll(a, r, 0)
        fields.append(out[:, :n].contiguous())
    return fields


def random_table(seed: int, p: int, n: int, device):
    """A dense table with many ties: small value ranges, negative khi/klo,
    and cls=0 entries whose other fields are nonzero (see ``tiled``)."""
    from bullet_tpu_torch.ops.merge import TableState

    rng = np.random.default_rng(seed)
    ranges = ((0, 4), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 4), (0, 5))
    w = min(n, BASE_N)
    blocks = [rng.integers(lo, hi, (p, w), dtype=np.int32) for lo, hi in ranges]
    return TableState(*tiled(blocks, n, device))


def clone(table):
    return type(table)(*(f.clone() for f in table))


def max_err(a, b) -> int:
    """Largest |a - b| over tables (or tensors), as a Python int; computed
    on 2^26-element chunks where they differ, so that a 2^30-entry table
    needs no int64 copies of its own size."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} tensors against {len(b)}")
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} against {tuple(y.shape)}")
        if torch.equal(x, y):
            continue
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, x.numel(), 1 << 26):
            d = x[i:i + (1 << 26)].to(torch.int64) - y[i:i + (1 << 26)].to(torch.int64)
            worst = max(worst, int(d.abs().max()))
    return worst


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phase 3


def check_merge(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops.merge import merge_tables, merge_tables_torch

    for p, n in ((1, 1), (3, 130), (64, 1000), (8, 4096)):
        for mode in ("reference", "lww"):
            a, b = random_table(11 + p, p, n, dev), random_table(23 + n, p, n, dev)
            got, c_got = merge_tables(a, b, mode)
            want, c_want = merge_tables_torch(a, b, mode)
            e = max(max_err(got, want), max_err(c_got, c_want))
            errs["merge"] = max(errs["merge"], e)
            if e:
                raise AssertionError(f"merge {mode} {p}x{n}: max_abs_err {e}")
    p, n = main_shape
    a, b = random_table(1, p, n, dev), random_table(2, p, n, dev)
    for mode in ("reference", "lww"):
        got, c_got = merge_tables(a, b, mode)
        want, c_want = merge_tables_torch(a, b, mode)
        e = max(max_err(got, want), max_err(c_got, c_want))
        errs["merge"] = max(errs["merge"], e)
        if e:
            raise AssertionError(f"merge {mode} {p}x{n}: max_abs_err {e}")
        del got, want
    times["merge"] = (
        time_ms(lambda: merge_tables(a, b, "reference"), 5),
        time_ms(lambda: merge_tables_torch(a, b, "reference"), 2),
        # reads 2 x 7 fields, writes 7; 6-key compare chain + 7 selects
        bound(84 * p * n, 19 * p * n),
    )
    log(f"  merge {p}x{n}: kernel {times['merge'][0]:.3f} ms, "
        f"plain {times['merge'][1]:.3f} ms per call; bit-identical")


def check_ring(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops.ring_kernel import ring_round, ring_round_torch

    for p in (1, 2, 3, 1000, 1024):
        n = 333 if p >= 1000 else 130
        base = random_table(100 + p, p, n, dev)
        for wrap in (True, False):
            for mode in ("reference", "lww"):
                got, c_got = ring_round(clone(base), mode, wrap)
                want, c_want = ring_round_torch(clone(base), mode, wrap)
                e = max(max_err(got, want), max_err(c_got, c_want))
                errs["ring_round"] = max(errs["ring_round"], e)
                if e:
                    raise AssertionError(
                        f"ring_round p={p} wrap={wrap} {mode}: max_abs_err {e}")
    p, n = main_shape
    base = random_table(3, p, n, dev)
    for wrap in (True, False):
        got, c_got = ring_round(clone(base), "reference", wrap)
        want, c_want = ring_round_torch(clone(base), "reference", wrap)
        e = max(max_err(got, want), max_err(c_got, c_want))
        errs["ring_round"] = max(errs["ring_round"], e)
        if e:
            raise AssertionError(f"ring_round {p}x{n} wrap={wrap}: max_abs_err {e}")
        del got, want
    work = clone(base)
    del base
    times["ring_round"] = (
        time_ms(lambda: ring_round(work, "reference", True), 5),
        time_ms(lambda: ring_round_torch(work, "reference", True), 2),
        bound(56 * p * n, 38 * p * n),  # 7 fields read + written, two merges
    )
    log(f"  ring_round {p}x{n}: kernel {times['ring_round'][0]:.3f} ms, "
        f"plain {times['ring_round'][1]:.3f} ms per call; bit-identical")


def _ids(dirty: np.ndarray, m: int, dev) -> torch.Tensor:
    from bullet_tpu_torch.ops.packed import frontier_ids_compact

    ids = frontier_ids_compact(torch.from_numpy(dirty).to(dev), len(dirty))
    if m > 1:
        ids = torch.cat([ids, torch.zeros(1, dtype=torch.int32, device=dev)])
    return ids


def _frontier_pair(table, ids, tile, wrap, mode, m):
    from bullet_tpu_torch.ops.ring_kernel import (
        frontier_round_dense,
        frontier_round_dense_torch,
    )

    t_total = table.cls.shape[1] // tile
    got, ids_got = frontier_round_dense(clone(table), ids, tile, wrap, mode, m)
    want, ids_want = frontier_round_dense_torch(clone(table), ids, tile, wrap, mode, m)
    count = int(ids_want[t_total])
    # cells past the count are unspecified
    e = max(
        max_err(got, want),
        max_err(ids_got[:count], ids_want[:count]),
        max_err(ids_got[t_total:], ids_want[t_total:]),
    )
    return e


def check_frontier(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops.ring_kernel import (
        frontier_round_dense,
        frontier_round_dense_torch,
        frontier_tile_n,
    )

    rng = np.random.default_rng(7)
    for p, n in ((1, 64), (3, 96), (64, 2048), (1000, 512)):
        tile = frontier_tile_n(n)
        t_total = n // tile
        table = random_table(200 + p, p, n, dev)
        for m in (1, 8):
            for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4):
                for wrap in (True, False):
                    for mode in ("reference", "lww"):
                        e = _frontier_pair(table, _ids(dirty, m, dev), tile, wrap, mode, m)
                        errs["frontier_round_dense"] = max(errs["frontier_round_dense"], e)
                        if e:
                            raise AssertionError(
                                f"frontier p={p} n={n} m={m} wrap={wrap} {mode}: "
                                f"max_abs_err {e}")
    p, n = main_shape
    tile = frontier_tile_n(n)
    t_total = n // tile
    table = random_table(4, p, n, dev)
    full = _ids(np.ones(t_total, bool), 8, dev)
    sparse = _ids(rng.random(t_total) < 0.1, 8, dev)
    for ids in (full, sparse):
        e = _frontier_pair(table, ids, tile, True, "reference", 8)
        errs["frontier_round_dense"] = max(errs["frontier_round_dense"], e)
        if e:
            raise AssertionError(f"frontier {p}x{n} m=8: max_abs_err {e}")
    times["frontier_round_dense"] = (
        time_ms(lambda: frontier_round_dense(table, full, tile, True, "reference", 8), 3),
        time_ms(lambda: frontier_round_dense_torch(table, full, tile, True, "reference", 8), 1),
        # one read and one write of the table whatever m (a fused kernel
        # that kept a column's rows on chip between rounds would need no
        # more); 8 rounds of compares
        bound(56 * p * n, 8 * 38 * p * n),
    )
    log(f"  frontier_round_dense {p}x{n} tile {tile}, m=8, all {t_total} stripes: "
        f"kernel {times['frontier_round_dense'][0]:.3f} ms, "
        f"plain {times['frontier_round_dense'][1]:.3f} ms per call; bit-identical")


def check_small_sims(dev):
    """The whole slice at a small size: a sim on the card (kernels) against
    the same sim on the CPU (plain versions), tables and rounds equal."""
    from bullet_tpu_torch import PeerNetworkSim

    for topology in ("ring", "chain"):
        for mode in ("reference", "lww"):
            sims = [
                PeerNetworkSim(64, capacity=4096, topology=topology, mode=mode,
                               device=d, use_kernels=True)
                for d in (dev, "cpu")
            ]
            rng = np.random.default_rng(5)
            peers = rng.integers(0, 64, 3000)
            paths = [f"s/{i}" for i in rng.integers(0, 3000, 3000)]
            vals = rng.integers(-20, 20, 3000)
            results = []
            for sim in sims:
                sim.put_bulk(peers, paths, vals)
                sim.put(3, "s/str", "pear")
                sim.put(60, "s/str", "apple")
                r1 = sim.step(2)
                r2 = sim.run_until_converged()
                sim.put(9, "s/late", 4)
                sim.reconcile()
                results.append((r1, r2, sim.tables_equal()))
            if results[0] != results[1] or not results[0][2]:
                raise AssertionError(f"small sim {topology} {mode}: {results}")
            e = max_err(sims[0].table, type(sims[1].table)(*(f.to(dev) for f in sims[1].table)))
            if e:
                raise AssertionError(f"small sim {topology} {mode}: max_abs_err {e}")
    log("  small sims (64 x 4096, ring/chain x reference/lww): card == CPU")


# ------------------------------------------------------ phase 3, packed

# field count -> layout of the packed family
LAYOUT_OF = {3: "packed", 2: "rank", 1: "rank1"}


def random_packed(seed: int, p: int, n: int, device):
    """A packed table (khi, klo, cv) with many ties, negative keys and
    absent (cls 0) entries with nonzero keys (see ``tiled``)."""
    from bullet_tpu_torch.ops.packed import PackedTable

    rng = np.random.default_rng(seed)
    w = min(n, BASE_N)
    cls, vid = rng.integers(0, 4, (p, w)), rng.integers(0, 5, (p, w))
    blocks = (rng.integers(-3, 3, (p, w)), rng.integers(-3, 3, (p, w)), (cls << 28) | vid)
    return PackedTable(*tiled(blocks, n, device))


def random_family(nf: int, seed: int, p: int, n: int, device):
    """A packed-family table of nf fields with many ties: packed as above;
    rank (rank, cv) and rank1 (rank) with ranks in [0, 6), 0 absent, and cv
    a function of the rank (equal keys mean equal entries, as in a sim)."""
    from bullet_tpu_torch.ops.rank import Rank1Table, RankTable

    if nf == 3:
        return random_packed(seed, p, n, device)
    rng = np.random.default_rng(seed)
    rank = rng.integers(0, 6, (p, min(n, BASE_N)))
    if nf == 1:
        return Rank1Table(*tiled((rank,), n, device))
    return RankTable(*tiled((rank, np.where(rank > 0, (1 << 28) | rank, 0)), n, device))


def tag(name: str, nf: int) -> str:
    """The times key of a kernel at a field count: the packed layout's
    bare, the others suffixed with their layout."""
    return name if nf == 3 else f"{name} {LAYOUT_OF[nf]}"


# the small, ragged and big-P shapes every packed-family kernel is held at
PACKED_SHAPES = ((1, 64), (3, 130), (64, 1000), (1000, 512), (4096, 256))
# rank1 P x N where the TPU's full-P window stripe ran out of VMEM and its
# halo window (#17) took over
HALO_WINDOW_SHAPE = (8192, 1 << 18)


def _pair(name, errs, got, want, what):
    e = max_err(got, want)
    errs[name] = max(errs[name], e)
    if e:
        raise AssertionError(f"{name} {what}: max_abs_err {e}")


def _random_ops(rng, p, n, k, dev, nf=3):
    """k raw ops over [p, n], pre-reduced and stacked [2 + nf, K] on the
    card: live and dead (cls 0, rank 0) values, many ties."""
    from bullet_tpu_torch.ops.packed import reduce_flat_ops
    from bullet_tpu_torch.ops.rank import reduce_flat_ops_rank

    peer, slot = rng.integers(0, p, k).astype(np.int32), rng.integers(0, n, k).astype(np.int32)
    if nf == 3:
        raw = (rng.integers(0, 5, k), rng.integers(-3, 3, k), rng.integers(-3, 3, k),
               rng.integers(0, 5, k))
        reduced = reduce_flat_ops(peer, slot, *(a.astype(np.int32) for a in raw))
    else:
        rank = rng.integers(0, 8, k).astype(np.int32)
        cv = np.where(rank > 0, (1 << 28) | rank, 0).astype(np.int32)
        reduced = reduce_flat_ops_rank(peer, slot, rank, cv)[: nf + 2]
    return torch.from_numpy(np.stack(reduced)).to(dev)


def timed_once(fn):
    """(fn(), ms): one call timed with CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_apply_packed(dev, main_shape, errs, times, nf):
    from bullet_tpu_torch.ops.packed import apply_flat_packed, apply_flat_packed_torch

    rng = np.random.default_rng(31 + nf)
    for p, n in PACKED_SHAPES:
        base = random_family(nf, 300 + p, p, n, dev)
        # a sparse batch and a dense one (many ops per 32-column sector)
        for k, cols in ((min(p * n, 4096), n), (min(p * n, 1 << 16), min(n, 512))):
            ops = _random_ops(rng, p, cols, k, dev, nf)
            got, c_got = apply_flat_packed(clone(base), ops)
            want, c_want = apply_flat_packed_torch(clone(base), ops)
            _pair("apply_packed", errs, (*got, c_got), (*want, c_want), f"nf={nf} {p}x{n} K={k}")
    # the main shape: one call each on identical tables, timed (the warm-up
    # calls on a small table keep first-use costs out of the times)
    p, n = main_shape
    ops = _random_ops(rng, p, n, 1 << 20, dev, nf)
    k = ops.shape[1]
    small, small_ops = random_family(nf, 6, 8, 4096, dev), _random_ops(rng, 8, 4096, 64, dev, nf)
    apply_flat_packed(clone(small), small_ops)
    apply_flat_packed_torch(small, small_ops)
    table = random_family(nf, 5, p, n, dev)
    (_, wins), ms = timed_once(lambda: apply_flat_packed(table, ops))
    twin = random_family(nf, 5, p, n, dev)
    (_, want_wins), plain = timed_once(lambda: apply_flat_packed_torch(twin, ops))
    _pair("apply_packed", errs, (*table, wins), (*twin, want_wins), f"nf={nf} {p}x{n} K={k}")
    del table, twin
    wins = int(wins)
    # reads each op ((2 + nf) x 4 B) and the entry it targets (nf x 4 B),
    # writes the wins
    times[tag("apply_packed", nf)] = (
        ms, plain, bound((8 + 8 * nf) * k + 4 * nf * wins, 11 * k))
    log(f"  apply_packed [{LAYOUT_OF[nf]}] {p}x{n}, K = {k} unique ops, {wins} land: kernel "
        f"{ms:.3f} ms (one call), plain {plain:.3f} ms; bit-identical at "
        f"{len(PACKED_SHAPES) + 1} shapes")


def round_bound(nf: int, entries: int, rounds: int = 1):
    """Bound of rounds over a table: one read and one write of nf x 4 bytes
    per entry; two merges a round of (nf + 1) compares and nf selects
    each."""
    return bound(8 * nf * entries, rounds * (4 * nf + 2) * entries)


def key_fields(nf: int) -> int:
    """Fields a compare reads: all three of the packed layout's, the rank
    alone of the rank layouts (their cv is payload)."""
    return 3 if nf == 3 else 1


def probe_bound(nf: int, entries: int):
    """Bound of the count-only probe: one read of the key fields and two
    compares an entry; it writes nothing."""
    return bound(4 * key_fields(nf) * entries, 2 * (nf + 1) * entries)


def check_packed_round(dev, main_shape, errs, times, nf):
    from bullet_tpu_torch.ops import packed as pk

    for p, n in PACKED_SHAPES:
        base = random_family(nf, 400 + p, p, n, dev)
        for wrap in (True, False):
            for m in (1, 8):
                got, c_got = pk.ring_multiround_packed(clone(base), wrap, m)
                want, c_want = pk.packed_round_torch(clone(base), wrap, m)
                _pair("packed_round", errs, (*got, c_got), (*want, c_want),
                      f"nf={nf} {p}x{n} wrap={wrap} m={m}")
            c_got = pk.count_changes_round_packed(base, wrap)
            _, c_want = pk.packed_round_torch(clone(base), wrap, 1, count_only=True)
            _pair("packed_round", errs, c_got, c_want, f"nf={nf} {p}x{n} wrap={wrap} count-only")
        del base
    # the main shape: the kernel on one table, the plain version on an
    # identical twin; each call leaves the two equal again for the next
    p, n = main_shape
    table, twin = random_family(nf, 7, p, n, dev), random_family(nf, 7, p, n, dev)
    plain = {}
    for what, wrap, m, count_only in (("chain", False, 1, False), ("ring", True, 1, False),
                                      ("count-only", True, 1, True), ("m=8", True, 8, False)):
        if count_only:
            got = (pk.count_changes_round_packed(table, wrap),)
        else:
            got = (*table, pk.ring_multiround_packed(table, wrap, m)[1])
        (_, c_want), plain[what] = timed_once(
            lambda: pk.packed_round_torch(twin, wrap, m, count_only))
        _pair("packed_round", errs, got, (c_want,) if count_only else (*twin, c_want),
              f"nf={nf} {p}x{n} {what}")
    del twin
    ms = time_ms(lambda: pk.ring_round_packed(table, True), 5)
    probe = time_ms(lambda: pk.count_changes_round_packed(table, True), 5)
    fused = time_ms(lambda: pk.ring_multiround_packed(table, True, 8), 2)
    del table
    times[tag("packed_round", nf)] = (ms, plain["ring"], round_bound(nf, p * n))
    times[tag("packed_round count-only", nf)] = (probe, plain["count-only"], probe_bound(nf, p * n))
    # one read and one write of the table whatever m: a fused kernel that
    # kept a column's rows on chip between rounds would need no more
    times[tag("packed_round m=8", nf)] = (fused, plain["m=8"], round_bound(nf, p * n, rounds=8))
    log(f"  packed_round [{LAYOUT_OF[nf]}] {p}x{n}: kernel {ms:.3f} ms, plain "
        f"{plain['ring']:.3f} ms per round; count-only {probe:.3f} ms (plain "
        f"{plain['count-only']:.3f}); m=8 {fused:.3f} ms (plain {plain['m=8']:.3f}) per call; "
        "ring, chain, count-only and m=8 bit-identical")


def check_reconcile_packed(dev, main_shape, errs, times, nf):
    from bullet_tpu_torch.ops.packed import reconcile_packed, reconcile_packed_torch

    for p, n in ((1, 64), (2, 64), (3, 130), (1000, 512), (1024, 256), (4096, 256)):
        base = random_family(nf, 500 + p, p, n, dev)
        _pair("reconcile_packed", errs, reconcile_packed(clone(base)),
              reconcile_packed_torch(clone(base)), f"nf={nf} {p}x{n}")
        del base
    p, n = main_shape
    table, twin = random_family(nf, 8, p, n, dev), random_family(nf, 8, p, n, dev)
    reconcile_packed(table)
    _, plain = timed_once(lambda: reconcile_packed_torch(twin))
    _pair("reconcile_packed", errs, table, twin, f"nf={nf} {p}x{n}")
    del twin
    ms = time_ms(lambda: reconcile_packed(table), 5)
    library = None
    if nf == 1:
        # one PyTorch reduction computes the rank1 reconcile: each column's
        # max rank, broadcast back to every row (the yardstick only; the
        # port never calls it)
        rank = table.rank

        def amax_copy():
            rank.copy_(torch.amax(rank, 0, keepdim=True).expand_as(rank))

        library = time_ms(amax_copy, 5)
    del table
    # the keys read once and every field written once: a rank layout's cv
    # is needed only from each column's winning row
    times[tag("reconcile_packed", nf)] = (
        ms, plain, bound(4 * (key_fields(nf) + nf) * p * n, (2 * nf + 1) * p * n), library)
    log(f"  reconcile_packed [{LAYOUT_OF[nf]}] {p}x{n}: kernel {ms:.3f} ms, plain {plain:.3f} ms"
        + (f", torch.amax + copy_ {library:.3f} ms" if library is not None else "")
        + " per call; bit-identical")


def check_frontier_packed(dev, main_shape, errs, times, nf):
    from bullet_tpu_torch.ops import packed as pk

    def pair(table, twin, ids, tile, wrap, m, what):
        t_total = table[0].shape[1] // tile
        _, ids_got = pk.frontier_round_packed(table, ids, tile, wrap, m)
        (_, ids_want), ms = timed_once(
            lambda: pk.frontier_round_packed_torch(twin, ids, tile, wrap, m))
        count = int(ids_want[t_total])
        _pair("frontier_round_packed", errs,
              (*table, ids_got[:count], ids_got[t_total:]),
              (*twin, ids_want[:count], ids_want[t_total:]), f"nf={nf} {what}")
        return count, ms

    rng = np.random.default_rng(9 + nf)
    for p, n in ((1, 64), (3, 96), (64, 2048), (1000, 512), (4096, 256)):
        tile = pk.frontier_tile_n(n)
        t_total = n // tile
        base = random_family(nf, 600 + p, p, n, dev)
        for m in (1, 8):
            for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4):
                for wrap in (True, False):
                    pair(clone(base), clone(base), _ids(dirty, m, dev), tile, wrap, m,
                         f"{p}x{n} m={m} wrap={wrap} dirty={int(dirty.sum())}/{t_total}")
        del base
    # the main shape, all stripes and then a sparse frontier: more than the
    # 1024 stripes the compaction block scans at a time, so its multi-chunk
    # scan runs
    p, n = main_shape
    tile = pk.frontier_tile_n(n)
    t_total = n // tile
    table, twin = random_family(nf, 9, p, n, dev), random_family(nf, 9, p, n, dev)
    full = _ids(np.ones(t_total, bool), 8, dev)
    steps = (("m=8 all", full, 8), ("m=1 all", _ids(np.ones(t_total, bool), 1, dev), 1),
             ("m=8 sparse", _ids(rng.random(t_total) < 0.4, 8, dev), 8))
    plain, report = None, []
    for what, ids, m in steps:
        active = int(ids[t_total])
        survivors, ms = pair(table, twin, ids, tile, True, m, f"{p}x{n} {what}")
        plain = plain if plain is not None else ms
        report.append(f"{what}: {active} -> {survivors} stripes")
    del twin
    ms = time_ms(lambda: pk.frontier_round_packed(table, full, tile, True, 8), 3)
    del table
    # one read and one write of the table whatever m (see packed_round m=8)
    times[tag("frontier_round_packed", nf)] = (ms, plain, round_bound(nf, p * n, rounds=8))
    log(f"  frontier_round_packed [{LAYOUT_OF[nf]}] {p}x{n} tile {tile}, m=8, all {t_total} "
        f"stripes: kernel {ms:.3f} ms, plain {plain:.3f} ms per call; bit-identical "
        f"({'; '.join(report)})")


def window_bound(nf: int, entries: int, m: int):
    """Bound of an m-round window join: one read and one write of the
    table; the compares of its O(log m) 3-way joins and the final round."""
    from bullet_tpu_torch.ops.packed import _window_chain

    joins = 2 * len(_window_chain(m - 1)) + 2
    return bound(8 * nf * entries, joins * (2 * nf + 1) * entries)


def check_window(dev, main_shape, errs, times, nf):
    """window_packed against its plain version: every depth of the list on
    small, ragged and big-P shapes, ring and chain; rank1 at P = 8192
    (where the TPU took its halo window, #17); the main shape, timed."""
    from bullet_tpu_torch.ops import packed as pk

    def pair(base, wrap, m, what):
        got, c_got = pk.ring_window_packed(clone(base), wrap, m)
        twin = clone(base)
        (want, c_want), plain = timed_once(lambda: pk.ring_window_packed_torch(twin, wrap, m))
        _pair("window_packed", errs, (*got, c_got), (*want, c_want), f"nf={nf} {what}")
        return plain

    for p, n in ((1, 64), (2, 64), (3, 130), (64, 1000), (1000, 512), (4096, 256)):
        base = random_family(nf, 700 + p, p, n, dev)
        for wrap in (True, False):
            for m in (1, 13, 120, 2 * p + 3):
                pair(base, wrap, m, f"{p}x{n} wrap={wrap} m={m}")
        del base
    if nf == 1:
        p, n = HALO_WINDOW_SHAPE
        base = random_family(nf, 71, p, n, dev)
        for wrap, m in ((True, 120), (False, 13)):
            pair(base, wrap, m, f"{p}x{n} wrap={wrap} m={m}")
        del base
        log(f"  window_packed [rank1] {p}x{n} (the TPU's halo-window shape): "
            "ring m=120, chain m=13 bit-identical")
        torch.cuda.empty_cache()
    p, n = main_shape
    base = random_family(nf, 72, p, n, dev)
    pair(base, False, 13, f"{p}x{n} chain m=13")
    plain = pair(base, True, 120, f"{p}x{n} ring m=120")
    ms = time_ms(lambda: pk.ring_window_packed(base, True, 120), 3)
    del base
    times[tag("window_packed", nf)] = (ms, plain, window_bound(nf, p * n, 120))
    log(f"  window_packed [{LAYOUT_OF[nf]}] {p}x{n}, ring m=120 "
        f"({len(pk._window_chain(119))} doubling steps + the last round): kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms per call; bit-identical with m in (1, 13, 120, 2P+3) at "
        "small, ragged and P = 4096 shapes")


def check_small_packed_sims(dev):
    """Packed, rank and rank1 ring and chain sims on the card against the
    same sims on the CPU, fast_forward included (a blind jump after step,
    and a tracked one after a converge: the packed sim takes the frontier
    route there on the card, the window on the CPU); then a P = 4096 packed
    ring on the card, converged, against the CPU's direct reconcile of the
    same writes."""
    from bullet_tpu_torch import PeerNetworkSim

    for layout, topology in itertools.product(("packed", "rank", "rank1"), ("ring", "chain")):
        sims = [
            PeerNetworkSim(64, capacity=4096, topology=topology, layout=layout,
                           device=d, use_kernels=True)
            for d in (dev, "cpu")
        ]
        rng = np.random.default_rng(6)
        peers = rng.integers(0, 64, 3000)
        paths = [f"s/{i}" for i in rng.integers(0, 3000, 3000)]
        vals = rng.integers(-20, 20, 3000)
        results = []
        for sim in sims:
            sim.put_bulk(peers, paths, vals)
            sim.put(3, "s/str", "pear")
            sim.put(60, "s/str", "apple")
            r1 = sim.step(2)
            f1 = sim.fast_forward(9)
            c1 = sim.converged()
            r2 = sim.run_until_converged()
            sim.put(9, "s/late", 4)
            sim.put(33, "s/str", "zest")
            f2 = (sim.fast_forward(5), sim.fast_forward(200))
            sim.put(40, "s/later", 5)
            sim.reconcile()
            results.append((r1, f1, c1, r2, f2, sim.converged(), sim.tables_equal(),
                            sim.stats["ops_applied"], sim.stats["windowed_rounds"]))
        if results[0] != results[1] or not results[0][6]:
            raise AssertionError(f"small {layout} sim {topology}: {results}")
        e = max_err(sims[0].table, type(sims[1].table)(*(f.to(dev) for f in sims[1].table)))
        if e:
            raise AssertionError(f"small {layout} sim {topology}: max_abs_err {e}")
    log("  small packed, rank and rank1 sims (64 x 4096, ring/chain, fast_forward included): "
        "card == CPU")

    sims = [PeerNetworkSim(4096, capacity=256, topology="ring", layout="packed", device=d)
            for d in (dev, "cpu")]
    rng = np.random.default_rng(7)
    peers = rng.integers(0, 4096, 20000)
    paths = [f"b/{i}" for i in rng.integers(0, 250, 20000)]
    vals = rng.integers(-500, 500, 20000)
    steps = []
    for sim in sims:
        sim.put_bulk(peers, paths, vals)
        steps.append(sim.step(1))
    e = max_err(sims[0].table, type(sims[1].table)(*(f.to(dev) for f in sims[1].table)))
    if e or steps[0] != steps[1]:
        raise AssertionError(f"P=4096 packed step: max_abs_err {e}, residuals {steps}")
    start = time.perf_counter()
    rounds = sims[0].run_until_converged()
    secs = time.perf_counter() - start
    sims[1].reconcile()
    e = max_err(sims[0].table, type(sims[1].table)(*(f.to(dev) for f in sims[1].table)))
    if e or sims[0].last_residual != 0 or not 0 < rounds <= 2049:
        raise AssertionError(f"P=4096 packed ring: {rounds} rounds, max_abs_err {e}")
    log(f"  packed ring 4096 x 256: step(1) card == CPU; converged in {rounds} rounds "
        f"({secs:.3f} s) == the CPU's direct reconcile")


# ------------------------------------------------------------------ phase 4


def expected_winners(op_peer, op_leaf, op_val):
    """Independent expectation of the converged entry of every written leaf
    under reference priority for numbers: the largest value, then the
    largest writer (peer), then the largest Lamport stamp. Stamps: each
    peer's clock starts at 0 and its ops count 1, 2, ... in batch order."""
    k = len(op_peer)
    order = np.argsort(op_peer, kind="stable")
    seq = np.empty(k, dtype=np.int64)
    sorted_peer = op_peer[order]
    first = np.r_[0, np.flatnonzero(np.diff(sorted_peer)) + 1]
    group = np.repeat(first, np.diff(np.r_[first, k]))
    seq[order] = np.arange(k) - group
    ctr = seq + 1
    o = np.lexsort((ctr, op_peer, op_val, op_leaf))
    leaf_s = op_leaf[o]
    last = np.flatnonzero(np.r_[leaf_s[1:] != leaf_s[:-1], True])
    w = o[last]
    return op_leaf[w], op_val[w], op_peer[w], ctr[w]


@contextlib.contextmanager
def wall_window(name: str, seconds: dict):
    """Time one main-path window on the host clock, the device drained at
    both ends; seconds[name] gets the result."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    yield
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - start


def main_path(args, dev, window=wall_window):
    """Phase 4. ``window(name, seconds)`` wraps each timed window (the
    profiling tool passes one that also traces the device)."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    p, n = args.peers, args.capacity
    secs: dict = {}
    rng = np.random.default_rng(args.seed)

    def make():
        return PeerNetworkSim(p, capacity=n, topology="ring", layout="dense", device=dev)

    sim = make()
    n_leaf = n - 256
    slot_of_leaf = sim.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
    op_peer = rng.integers(0, p, args.ops).astype(np.int32)
    op_leaf = rng.integers(0, n_leaf, args.ops)
    op_val = rng.integers(-500, 500, args.ops)

    _build.reset_launches()
    with window("put", secs):
        sim.put_bulk(op_peer, slot_of_leaf[op_leaf], op_val)
        sim.put(5, "s/name", "alice")
        sim.put(p - 1, "s/name", "bob")
        sim.put(17, "s/n", 3.5)
        sim.put(p // 2, "s/obj", {"a": 1, "b": "x"})
    with window("step(1)", secs):
        residual = sim.step(1)
    with window("run_until_converged", secs):
        rounds = sim.run_until_converged()
    route = sim._convergence_strategy()[0]
    conv = secs["run_until_converged"]
    log(f"  put_bulk {args.ops} ops + 4 scalar puts: {secs['put']:.3f} s (host)")
    log(f"  step(1) (apply + 1 ring round): {secs['step(1)']:.3f} s, "
        f"residual {residual}")
    log(f"  run_until_converged [{route}]: {rounds} rounds in {conv:.3f} s "
        f"({1000 * conv / max(rounds, 1):.3f} ms/round)")
    if route != "dense-frontier":
        raise AssertionError(f"main path took the {route} route")
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("run_until_converged did not reach the fixed point")
    if not all(bool((f == f[0:1]).all()) for f in sim.table):
        raise AssertionError("converged rows differ in some field")

    leaf, val, writer, ctr = expected_winners(op_peer, op_leaf, op_val)
    slots = slot_of_leaf[leaf]
    row = [f[0].cpu().numpy() for f in sim.table]
    written = np.zeros(n, bool)
    written[slots] = True
    k_slots = slot_of_leaf[: n_leaf]
    checks = {
        "writer": np.array_equal(row[4][slots], writer),
        "ctr": np.array_equal(row[5][slots], ctr),
        "tick": bool((row[6][slots] == 1).all()),
        "absent": bool((row[0][k_slots[~written[k_slots]]] == 0).all()),
    }
    got_vals = sim.get_bulk(0, slots.astype(np.int32))
    checks["values"] = got_vals == val.tolist()
    sample = rng.choice(len(leaf), 64, replace=False)
    sample_peers = rng.integers(0, p, 64)
    checks["get_bulk"] = sim.get_bulk(
        sample_peers, [f"k/{leaf[i]}" for i in sample]) == val[sample].tolist()
    checks["get"] = all(
        sim.get(int(q), f"k/{leaf[i]}") == val[i] for q, i in zip(sample_peers[:8], sample[:8])
    )
    checks["strings"] = (
        sim.get(3, "s") == {"name": "bob", "n": 3.5, "obj": {"a": 1, "b": "x"}}
    )
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"converged state disagrees with the expectation: {bad}")
    log(f"  converged state == numpy lexmax over {len(leaf)} written slots; "
        f"get/get_bulk agree")

    more = max(1, args.ops // 16)
    sim.put_bulk(
        rng.integers(0, p, more).astype(np.int32),
        slot_of_leaf[rng.integers(0, n_leaf, more)], rng.integers(-600, 600, more),
    )
    sim.put(7, "s/name", "carol")
    with window("step(0)", secs):  # apply the late writes, no round
        sim.step(0)
    snap = sim.snapshot()
    twin = make()
    twin.restore(snap)
    del snap
    with window("reconcile", secs):
        sim.reconcile()
    with window("twin run_until_converged", secs):
        twin_rounds = twin.run_until_converged()
    if not all(torch.equal(a, b) for a, b in zip(sim.table, twin.table)):
        raise AssertionError("reconcile() differs from the converged twin")
    if sim.get(0, "s/name") != "carol":
        raise AssertionError("late write lost")
    log(f"  step(0) (apply {more + 1} late ops): {secs['step(0)']:.3f} s")
    log(f"  reconcile ({(p - 1).bit_length()} doubling merges): "
        f"{secs['reconcile']:.3f} s; twin run_until_converged {twin_rounds} rounds "
        f"in {secs['twin run_until_converged']:.3f} s; tables identical")
    launches = {k: _build.LAUNCHES[k] for k in DENSE_KERNELS}
    log(f"  launches on the dense main path: {dict(_build.LAUNCHES)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"dense main path never launched: {missing}")
    return launches


# ------------------------------------------------------------------ phase 5


def leaf_max(op_leaf, op_val, n_leaf):
    """Independent expectation of the packed layout's converged value of
    every leaf: the largest number written to it (numbers order by value;
    an equal number is the same interned value), NaN where none was."""
    best = np.full(n_leaf, -np.inf)
    np.maximum.at(best, op_leaf, op_val.astype(np.float64))
    return np.where(np.isinf(best), np.nan, best)


def check_leaf_values(sim, batches, slot_of_leaf, rng, tag: str) -> int:
    """Hold a converged packed-family sim's values at peer 0 (one get_bulk
    over every leaf), at 64 random peers (get_bulk) and 8 (get) against
    the numpy per-leaf max of the (leaf, value) ``batches`` written;
    unwritten leaves must read None. Returns the written leaf count."""
    n_leaf = len(slot_of_leaf)
    leaf = np.concatenate([b[0] for b in batches])
    vals = np.concatenate([b[1] for b in batches])
    want = leaf_max(leaf, vals, n_leaf)
    written = ~np.isnan(want)
    got = sim.get_bulk(0, slot_of_leaf.astype(np.int32))
    got = np.array([np.nan if v is None else v for v in got], dtype=np.float64)
    if not np.array_equal(got[written], want[written]) or not np.isnan(got[~written]).all():
        raise AssertionError(f"{tag}: converged values disagree with the numpy per-leaf max")
    sample = rng.choice(np.flatnonzero(written), 64, replace=False)
    peers = rng.integers(0, sim.num_peers, 64)
    if sim.get_bulk(peers, [f"k/{i}" for i in sample]) != want[sample].tolist():
        raise AssertionError(f"{tag}: get_bulk at random peers disagrees")
    if not all(sim.get(int(q), f"k/{i}") == want[i] for q, i in zip(peers[:8], sample[:8])):
        raise AssertionError(f"{tag}: get disagrees")
    return int(written.sum())


def packed_main_path(args, dev, window=wall_window):
    """Phase 5. ``window(name, seconds)`` wraps each timed window."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    p, n = args.peers, args.packed_capacity
    secs: dict = {}
    rng = np.random.default_rng(args.seed + 1)

    def make():
        return PeerNetworkSim(p, capacity=n, topology="ring", layout="packed", device=dev,
                              use_kernels=True)

    sim = make()
    t_total = n // sim._frontier_tile()
    n_leaf = n - 256
    slot_of_leaf = sim.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
    batches = []

    def batch(k, leaves):
        peers = rng.integers(0, p, k).astype(np.int32)
        leaf = rng.integers(0, leaves, k)
        vals = rng.integers(-500, 500, k)
        batches.append((leaf, vals))
        return peers, slot_of_leaf[leaf], vals

    seeds = []  # dirty stripes each frontier run starts from
    seed_of = sim._frontier_seed

    def logged_seed(t):
        dirty = seed_of(t)
        seeds.append(int(dirty.sum()))
        return dirty

    sim._frontier_seed = logged_seed

    _build.reset_launches()
    first = batch(args.packed_ops, n_leaf)
    with window("packed put", secs):
        sim.put_bulk(*first)
        sim.put(5, "s/name", "alice")
        sim.put(p - 1, "s/name", "bob")
        sim.put(p // 2, "s/obj", {"a": 1, "b": "x"})
    with window("packed step(1)", secs):
        residual = sim.step(1)
    applied = sim.stats["ops_applied"]
    with window("packed run_until_converged", secs):
        rounds = sim.run_until_converged()
    route = sim._convergence_strategy()[0]
    conv = secs["packed run_until_converged"]
    log(f"  put_bulk {args.packed_ops} ops + 3 string/object puts: "
        f"{secs['packed put']:.3f} s (host)")
    log(f"  step(1) (reduce + apply {applied} winning ops + 1 ring round): "
        f"{secs['packed step(1)']:.3f} s, residual {residual}")
    log(f"  run_until_converged [{route}]: {rounds} rounds in {conv:.3f} s "
        f"({1000 * conv / max(rounds, 1):.3f} ms/round), seed {seeds[-1]}/{t_total} stripes")
    if route != "packed-frontier-local":
        raise AssertionError(f"packed main path took the {route} route")
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("packed run_until_converged did not reach the fixed point")
    if not all(bool((f == f[0:1]).all()) for f in sim.table):
        raise AssertionError("converged packed rows differ in some field")

    def check_values(tag):
        return check_leaf_values(sim, batches, slot_of_leaf, rng, f"packed {tag}")

    n_written = check_values("converge")
    if sim.get(3, "s") != {"name": "bob", "obj": {"a": 1, "b": "x"}}:
        raise AssertionError(f"string/object puts: {sim.get(3, 's')}")
    log(f"  converged row == numpy per-leaf max over {n_written} written leaves; "
        "get/get_bulk agree")

    # a hot range: the second batch writes the first 2^16 leaves only
    second = batch(max(1, args.packed_ops // 16), min(n_leaf, 1 << 16))
    with window("packed incremental converge", secs):
        sim.put_bulk(*second)
        inc_rounds = sim.run_until_converged()
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("incremental converge did not reach the fixed point")
    log(f"  put_bulk {len(second[0])} ops + run_until_converged: {inc_rounds} rounds in "
        f"{secs['packed incremental converge']:.3f} s, seed {seeds[-1]}/{t_total} stripes")
    with window("packed converged()", secs):
        done = sim.converged()
    if not done:
        raise AssertionError("converged() is False after a converged run")
    log(f"  converged() (count-only probe): True in {secs['packed converged()']:.3f} s")

    third = batch(args.packed_ops, n_leaf)
    sim.put_bulk(*third)
    sim.put(7, "s/name", "carol")
    with window("packed step(0)", secs):  # apply the late writes, no round
        sim.step(0)
    with window("packed snapshot+restore", secs):
        snap = sim.snapshot()
        twin = make()
        twin.restore(snap)
        del snap
    with window("packed reconcile", secs):
        sim.reconcile()
    # restore leaves no dirty-stripe tracking: a blind jump, which takes the
    # window kernel; 513 rounds pass the 1024-ring's diameter of 512
    jump = p // 2 + 1
    route = twin._fast_forward_route()
    with window("packed twin fast_forward", secs):
        twin_residual = twin.fast_forward(jump)
    if route != "window" or twin_residual != 0:
        raise AssertionError(f"twin fast_forward({jump}) [{route}]: residual {twin_residual}")
    if not all(torch.equal(a, b) for a, b in zip(sim.table, twin.table)):
        raise AssertionError("packed reconcile() differs from the fast-forwarded twin")
    del twin
    n_written = check_values("reconcile")
    if sim.get(0, "s/name") != "carol":
        raise AssertionError("late write lost")
    log(f"  step(0) (apply {len(third[0]) + 1} late ops): {secs['packed step(0)']:.3f} s; "
        f"snapshot + restore into a twin: {secs['packed snapshot+restore']:.3f} s")
    log(f"  reconcile (one kernel pass): {secs['packed reconcile']:.3f} s; twin "
        f"fast_forward({jump}) [{route}] to residual 0 in "
        f"{secs['packed twin fast_forward']:.3f} s; tables identical; "
        f"{n_written} leaves == numpy per-leaf max")
    launches = {k: _build.LAUNCHES[k] for k in PACKED_KERNELS}
    log(f"  launches on the packed main path: {dict(_build.LAUNCHES)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"packed main path never launched: {missing}")
    return launches


# ------------------------------------------------------------------ phase 6


def rank1_main_path(args, dev, window=wall_window, card=""):
    """Phase 6: the rank1 layout (4 B/entry) on a ring at P x N (default
    1024 x 2^20, 4.3 GB). Returns (launches, windowed logical merges/s of
    fast_forward(480))."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    p, n = args.peers, args.rank1_capacity
    secs: dict = {}
    rng = np.random.default_rng(args.seed + 2)
    n_leaf = n - 256
    peers = rng.integers(0, p, args.rank1_ops).astype(np.int32)
    leaves = rng.integers(0, n_leaf, args.rank1_ops)
    vals = rng.integers(-500, 500, args.rank1_ops)
    batches = [(leaves, vals)]

    def make_and_put(timed):
        """A rank1 sim with the first batch and the string puts queued. A
        twin takes the same puts, so its interners and RankIndex equal the
        main sim's (a snapshot holds neither); restore discards its queue."""
        sim = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device=dev)
        slots = sim.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
        with window("rank1 put", secs) if timed else contextlib.nullcontext():
            sim.put_bulk(peers, slots[leaves], vals)
            sim.put(5, "s/name", "alice")
            sim.put(p - 1, "s/name", "bob")
            sim.put(p // 2, "s/obj", {"a": 1, "b": "x"})
        return sim, slots

    _build.reset_launches()
    sim, slot_of_leaf = make_and_put(True)
    with window("rank1 step(1)", secs):
        residual = sim.step(1)
    applied = sim.stats["ops_applied"]
    twins = [make_and_put(False)[0] for _ in range(2)]
    with window("rank1 snapshot + 2 restores", secs):
        snap = sim.snapshot()
        for twin in twins:
            twin.restore(snap)
        del snap
    with window("rank1 run_until_converged", secs):
        rounds = sim.run_until_converged()
    route = sim._convergence_strategy()[0]
    conv = secs["rank1 run_until_converged"]
    log(f"  put_bulk {args.rank1_ops} ops + 3 string/object puts: "
        f"{secs['rank1 put']:.3f} s (host, RankIndex inserts included)")
    log(f"  step(1) (rank stamp + reduce + apply {applied} winning ops + 1 ring round): "
        f"{secs['rank1 step(1)']:.3f} s, residual {residual}")
    log(f"  snapshot + restore into 2 twins (4 B/entry): "
        f"{secs['rank1 snapshot + 2 restores']:.3f} s")
    log(f"  run_until_converged [{route}]: {rounds} rounds in {conv:.3f} s "
        f"({1000 * conv / max(rounds, 1):.3f} ms/round)")
    if route != "packed-frontier-local":
        raise AssertionError(f"rank1 main path took the {route} route")
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("rank1 run_until_converged did not reach the fixed point")

    def check_values(tag):
        return check_leaf_values(sim, batches, slot_of_leaf, rng, f"rank1 {tag}")

    n_written = check_values("converge")
    if sim.get(3, "s") != {"name": "bob", "obj": {"a": 1, "b": "x"}}:
        raise AssertionError(f"rank1 string/object puts: {sim.get(3, 's')}")
    log(f"  converged row == numpy per-leaf max over {n_written} written leaves "
        "(ranks decoded through the RankIndex); get/get_bulk agree")

    # 480 rounds stay under the ring's diameter of 512, so every round the
    # jump counts changes state (a smaller ring jumps P/2 - 1)
    jumper, stepper = twins
    depth = min(480, p // 2 - 1)
    ff_route = jumper._fast_forward_route()
    with window("rank1 fast_forward(k)", secs):
        r_ff = jumper.fast_forward(depth)
    with window("rank1 step(k)", secs):
        r_step = stepper.step(depth)
    if ff_route != "window" or r_ff != r_step or r_ff == 0:
        raise AssertionError(f"fast_forward({depth}) [{ff_route}] residual {r_ff}, "
                             f"step({depth}) residual {r_step}")
    if not torch.equal(jumper.table.rank, stepper.table.rank):
        raise AssertionError(f"fast_forward({depth}) differs from step({depth})")
    del stepper, twins
    with window("rank1 fast_forward to the fixed point", secs):
        r_fix = jumper.fast_forward(p)
    if r_fix != 0 or not torch.equal(jumper.table.rank, sim.table.rank):
        raise AssertionError(f"fast_forward to the fixed point: residual {r_fix}, "
                             "table differs from the converged sim")
    del jumper
    ff = secs["rank1 fast_forward(k)"]
    rate = 2 * p * n * depth / ff
    log(f"  fast_forward({depth}) [window]: {ff:.4f} s == step({depth}) "
        f"{secs['rank1 step(k)']:.3f} s (tables identical, residual {r_ff}); "
        f"fast_forward({p}) more: residual 0 in "
        f"{secs['rank1 fast_forward to the fixed point']:.4f} s, == the converged table")
    log(f"  windowed logical merges/s (2 x {p} x {n} x {depth} / s): {rate:.6g} on {card}")

    third_leaves = rng.integers(0, n_leaf, args.rank1_ops)
    third_vals = rng.integers(-600, 600, args.rank1_ops)
    batches.append((third_leaves, third_vals))
    sim.put_bulk(rng.integers(0, p, args.rank1_ops).astype(np.int32),
                 slot_of_leaf[third_leaves], third_vals)
    sim.put(7, "s/name", "carol")
    with window("rank1 reconcile", secs):
        sim.reconcile()
    with window("rank1 converged()", secs):
        done = sim.converged()
    if not done or not sim.tables_equal():
        raise AssertionError("rank1 reconcile did not reach the fixed point")
    n_written = check_values("reconcile")
    if sim.get(0, "s/name") != "carol":
        raise AssertionError("rank1 late write lost")
    log(f"  reconcile (apply {args.rank1_ops + 1} late ops + one kernel pass): "
        f"{secs['rank1 reconcile']:.3f} s; converged() (count-only probe): True in "
        f"{secs['rank1 converged()']:.4f} s; {n_written} leaves == numpy per-leaf max")
    launches = {k: _build.LAUNCHES[k] for k in PACKED_KERNELS}
    log(f"  launches on the rank1 main path: {dict(_build.LAUNCHES)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"rank1 main path never launched: {missing}")
    return launches, rate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--ops", type=int, default=1 << 20)
    ap.add_argument("--packed-capacity", type=int, default=1 << 20)
    ap.add_argument("--packed-ops", type=int, default=1 << 20)
    ap.add_argument("--rank1-capacity", type=int, default=1 << 20)
    ap.add_argument("--rank1-ops", type=int, default=1 << 20)
    return ap


def main() -> int:
    args = build_parser().parse_args()
    started = time.perf_counter()

    log("phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    log("phase 2: build")
    from bullet_tpu_torch import _build

    _build.library()
    log(f"  kernels built and loaded in {_build.build_seconds:.2f} s")

    log("phase 3: kernels against their plain versions (exact)")
    main_shape = (args.peers, args.capacity)
    packed_shape = (args.peers, args.packed_capacity)
    errs = {k: 0 for k in KERNELS}
    times = {}
    check_merge(dev, main_shape, errs, times)
    torch.cuda.empty_cache()
    check_ring(dev, main_shape, errs, times)
    torch.cuda.empty_cache()
    check_frontier(dev, main_shape, errs, times)
    torch.cuda.empty_cache()
    # the packed-family kernels at every field count: packed, rank, rank1
    for nf in (3, 2, 1):
        for check in (check_apply_packed, check_packed_round, check_reconcile_packed,
                      check_frontier_packed, check_window):
            check(dev, packed_shape, errs, times, nf)
            torch.cuda.empty_cache()
    check_small_sims(dev)
    check_small_packed_sims(dev)
    torch.cuda.empty_cache()

    log(f"phase 4: dense main path, ring {args.peers} x {args.capacity}")
    launches = main_path(args, dev)
    torch.cuda.empty_cache()
    log(f"phase 5: packed main path, ring {args.peers} x {args.packed_capacity}")
    launches.update(packed_main_path(args, dev))
    torch.cuda.empty_cache()
    log(f"phase 6: rank1 main path, ring {args.peers} x {args.rank1_capacity}")
    rank1_launches, _ = rank1_main_path(args, dev, card=smi)

    # one row per kernel at the layout its main path drives (dense: phase
    # 4, packed: phase 5), and one per packed-family kernel at rank1
    # (phase 6); the rank (nf = 2) times are in the log above
    rows = [(name, name, launches[name]) for name in KERNELS]
    rows += [(tag(name, 1), name, rank1_launches[name]) for name in PACKED_KERNELS]
    kernels = []
    for row, name, count in rows:
        src, rep = KERNELS[name]
        ms, plain_ms, (bound_ms, bound_by), *library = times[row]
        kernels.append({
            "name": row, "route": "cuda", "source": src, "replaces": rep,
            "launches": count, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # only the rank1 reconcile has one PyTorch call that computes
            # the same function (a column amax and a broadcast copy); no
            # single call computes the lexicographic multi-key selects
            "library_ms": library[0] if library else None,
        })
    log(f"chip_smoke: all phases passed in {time.perf_counter() - started:.1f} s of wall time")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
