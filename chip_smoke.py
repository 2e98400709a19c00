#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (bullet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--peers P] [--capacity N] [--ops K]
                          [--packed-capacity N] [--packed-ops K]

Phases, in order; any failure raises and exits nonzero:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the kernels of bullet_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, bit-identical (tolerance: exact, the path is all int32), at
   small and ragged shapes, at P = 4096 (where the TPU took its peer-tile
   kernels) and at the main-path shapes, with times per call there; then
   small sims on the card against the same sims on the CPU;
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
   and reconcile against a twin restored from a snapshot that converges,
   get/get_bulk.

Every kernel's launch count over the phase that drives its path (4 for
the dense kernels, 5 for the packed ones) must be > 0. The last two lines
are a JSON object describing the kernels and the contract line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
}
DENSE_KERNELS = ("merge", "ring_round", "frontier_round_dense")
PACKED_KERNELS = ("apply_packed", "packed_round", "reconcile_packed", "frontier_round_packed")

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


def random_packed(seed: int, p: int, n: int, device):
    """A packed table (khi, klo, cv) with many ties, negative keys and
    absent (cls 0) entries with nonzero keys (see ``tiled``)."""
    from bullet_tpu_torch.ops.packed import PackedTable

    rng = np.random.default_rng(seed)
    w = min(n, BASE_N)
    cls, vid = rng.integers(0, 4, (p, w)), rng.integers(0, 5, (p, w))
    blocks = (rng.integers(-3, 3, (p, w)), rng.integers(-3, 3, (p, w)), (cls << 28) | vid)
    return PackedTable(*tiled(blocks, n, device))


# the small, ragged and big-P shapes every packed kernel is held at
PACKED_SHAPES = ((1, 64), (3, 130), (64, 1000), (1000, 512), (4096, 256))


def _pair(name, errs, got, want, what):
    e = max_err(got, want)
    errs[name] = max(errs[name], e)
    if e:
        raise AssertionError(f"{name} {what}: max_abs_err {e}")


def _random_ops(rng, p, n, k, dev):
    """k raw ops over [p, n], pre-reduced and stacked [5, K] on the card:
    live and dead (cls 0) values, many ties."""
    from bullet_tpu_torch.ops.packed import reduce_flat_ops

    raw = (rng.integers(0, p, k), rng.integers(0, n, k), rng.integers(0, 5, k),
           rng.integers(-3, 3, k), rng.integers(-3, 3, k), rng.integers(0, 5, k))
    reduced = reduce_flat_ops(*(a.astype(np.int32) for a in raw))
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


def check_apply_packed(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops.packed import apply_flat_packed, apply_flat_packed_torch

    rng = np.random.default_rng(31)
    for p, n in PACKED_SHAPES:
        base = random_packed(300 + p, p, n, dev)
        # a sparse batch and a dense one (many ops per 32-column sector)
        for k, cols in ((min(p * n, 4096), n), (min(p * n, 1 << 16), min(n, 512))):
            ops = _random_ops(rng, p, cols, k, dev)
            got, c_got = apply_flat_packed(clone(base), ops)
            want, c_want = apply_flat_packed_torch(clone(base), ops)
            _pair("apply_packed", errs, (*got, c_got), (*want, c_want), f"{p}x{n} K={k}")
    # the main shape: one call each on identical tables, timed (the warm-up
    # calls on a small table keep first-use costs out of the times)
    p, n = main_shape
    ops = _random_ops(rng, p, n, 1 << 20, dev)
    k = ops.shape[1]
    small, small_ops = random_packed(6, 8, 4096, dev), _random_ops(rng, 8, 4096, 64, dev)
    apply_flat_packed(clone(small), small_ops)
    apply_flat_packed_torch(small, small_ops)
    table = random_packed(5, p, n, dev)
    (_, wins), ms = timed_once(lambda: apply_flat_packed(table, ops))
    twin = random_packed(5, p, n, dev)
    (_, want_wins), plain = timed_once(lambda: apply_flat_packed_torch(twin, ops))
    _pair("apply_packed", errs, (*table, wins), (*twin, want_wins), f"{p}x{n} K={k}")
    del table, twin
    wins = int(wins)
    # reads each op (20 B) and the entry it targets (12 B), writes the wins
    times["apply_packed"] = (ms, plain, bound(32 * k + 12 * wins, 11 * k))
    log(f"  apply_packed {p}x{n}, K = {k} unique ops, {wins} land: kernel {ms:.3f} ms "
        f"(one call), plain {plain:.3f} ms; bit-identical at {len(PACKED_SHAPES) + 1} shapes")


def check_packed_round(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops import packed as pk

    for p, n in PACKED_SHAPES:
        base = random_packed(400 + p, p, n, dev)
        for wrap in (True, False):
            for m in (1, 8):
                got, c_got = pk.ring_multiround_packed(clone(base), wrap, m)
                want, c_want = pk.packed_round_torch(clone(base), wrap, m)
                _pair("packed_round", errs, (*got, c_got), (*want, c_want),
                      f"{p}x{n} wrap={wrap} m={m}")
            c_got = pk.count_changes_round_packed(base, wrap)
            _, c_want = pk.packed_round_torch(clone(base), wrap, 1, count_only=True)
            _pair("packed_round", errs, c_got, c_want, f"{p}x{n} wrap={wrap} count-only")
        del base
    # the main shape: the kernel on one table, the plain version on an
    # identical twin; each call leaves the two equal again for the next
    p, n = main_shape
    table, twin = random_packed(7, p, n, dev), random_packed(7, p, n, dev)
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
              f"{p}x{n} {what}")
    del twin
    ms = time_ms(lambda: pk.ring_round_packed(table, True), 5)
    probe = time_ms(lambda: pk.count_changes_round_packed(table, True), 5)
    fused = time_ms(lambda: pk.ring_multiround_packed(table, True, 8), 2)
    del table
    times["packed_round"] = (ms, plain["ring"], bound(24 * p * n, 22 * p * n))
    times["packed_round count-only"] = (probe, plain["count-only"], bound(12 * p * n, 22 * p * n))
    # one read and one write of the table whatever m: a fused kernel that
    # kept a column's rows on chip between rounds would need no more
    times["packed_round m=8"] = (fused, plain["m=8"], bound(24 * p * n, 8 * 22 * p * n))
    log(f"  packed_round {p}x{n}: kernel {ms:.3f} ms, plain {plain['ring']:.3f} ms per round; "
        f"count-only {probe:.3f} ms (plain {plain['count-only']:.3f}); m=8 {fused:.3f} ms "
        f"(plain {plain['m=8']:.3f}) per call; ring, chain, count-only and m=8 bit-identical")


def check_reconcile_packed(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops.packed import reconcile_packed, reconcile_packed_torch

    for p, n in ((1, 64), (2, 64), (3, 130), (1000, 512), (1024, 256), (4096, 256)):
        base = random_packed(500 + p, p, n, dev)
        _pair("reconcile_packed", errs, reconcile_packed(clone(base)),
              reconcile_packed_torch(clone(base)), f"{p}x{n}")
        del base
    p, n = main_shape
    table, twin = random_packed(8, p, n, dev), random_packed(8, p, n, dev)
    reconcile_packed(table)
    _, plain = timed_once(lambda: reconcile_packed_torch(twin))
    _pair("reconcile_packed", errs, table, twin, f"{p}x{n}")
    del twin
    ms = time_ms(lambda: reconcile_packed(table), 5)
    del table
    times["reconcile_packed"] = (ms, plain, bound(24 * p * n, 11 * p * n))
    log(f"  reconcile_packed {p}x{n}: kernel {ms:.3f} ms, plain {plain:.3f} ms per call; "
        "bit-identical")


def check_frontier_packed(dev, main_shape, errs, times):
    from bullet_tpu_torch.ops import packed as pk

    def pair(table, twin, ids, tile, wrap, m, what):
        t_total = table[0].shape[1] // tile
        _, ids_got = pk.frontier_round_packed(table, ids, tile, wrap, m)
        (_, ids_want), ms = timed_once(
            lambda: pk.frontier_round_packed_torch(twin, ids, tile, wrap, m))
        count = int(ids_want[t_total])
        _pair("frontier_round_packed", errs,
              (*table, ids_got[:count], ids_got[t_total:]),
              (*twin, ids_want[:count], ids_want[t_total:]), what)
        return count, ms

    rng = np.random.default_rng(9)
    for p, n in ((1, 64), (3, 96), (64, 2048), (1000, 512), (4096, 256)):
        tile = pk.frontier_tile_n(n)
        t_total = n // tile
        base = random_packed(600 + p, p, n, dev)
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
    table, twin = random_packed(9, p, n, dev), random_packed(9, p, n, dev)
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
    times["frontier_round_packed"] = (ms, plain, bound(24 * p * n, 8 * 22 * p * n))
    log(f"  frontier_round_packed {p}x{n} tile {tile}, m=8, all {t_total} stripes: "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms per call; bit-identical "
        f"({'; '.join(report)})")


def check_small_packed_sims(dev):
    """Packed ring and chain sims on the card against the same sims on the
    CPU; then a P = 4096 ring on the card, converged, against the CPU's
    direct reconcile of the same writes."""
    from bullet_tpu_torch import PeerNetworkSim

    for topology in ("ring", "chain"):
        sims = [
            PeerNetworkSim(64, capacity=4096, topology=topology, layout="packed",
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
            c1 = sim.converged()
            r2 = sim.run_until_converged()
            sim.put(9, "s/late", 4)
            sim.reconcile()
            results.append((r1, c1, r2, sim.converged(), sim.tables_equal(),
                            sim.stats["ops_applied"]))
        if results[0] != results[1] or not results[0][4]:
            raise AssertionError(f"small packed sim {topology}: {results}")
        e = max_err(sims[0].table, type(sims[1].table)(*(f.to(dev) for f in sims[1].table)))
        if e:
            raise AssertionError(f"small packed sim {topology}: max_abs_err {e}")
    log("  small packed sims (64 x 4096, ring/chain): card == CPU")

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
        leaf = np.concatenate([b[0] for b in batches])
        vals = np.concatenate([b[1] for b in batches])
        want = leaf_max(leaf, vals, n_leaf)
        written = ~np.isnan(want)
        got = sim.get_bulk(0, slot_of_leaf.astype(np.int32))
        got = np.array([np.nan if v is None else v for v in got], dtype=np.float64)
        if not np.array_equal(got[written], want[written]) or not np.isnan(got[~written]).all():
            raise AssertionError(f"{tag}: converged values disagree with the numpy per-leaf max")
        sample = rng.choice(np.flatnonzero(written), 64, replace=False)
        peers = rng.integers(0, p, 64)
        if sim.get_bulk(peers, [f"k/{i}" for i in sample]) != want[sample].tolist():
            raise AssertionError(f"{tag}: get_bulk at random peers disagrees")
        if not all(sim.get(int(q), f"k/{i}") == want[i] for q, i in zip(peers[:8], sample[:8])):
            raise AssertionError(f"{tag}: get disagrees")
        return int(written.sum())

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
    with window("packed twin run_until_converged", secs):
        twin_rounds = twin.run_until_converged()
    if not all(torch.equal(a, b) for a, b in zip(sim.table, twin.table)):
        raise AssertionError("packed reconcile() differs from the converged twin")
    del twin
    n_written = check_values("reconcile")
    if sim.get(0, "s/name") != "carol":
        raise AssertionError("late write lost")
    log(f"  step(0) (apply {len(third[0]) + 1} late ops): {secs['packed step(0)']:.3f} s; "
        f"snapshot + restore into a twin: {secs['packed snapshot+restore']:.3f} s")
    log(f"  reconcile (one kernel pass): {secs['packed reconcile']:.3f} s; twin "
        f"run_until_converged {twin_rounds} rounds in "
        f"{secs['packed twin run_until_converged']:.3f} s; tables identical; "
        f"{n_written} leaves == numpy per-leaf max")
    launches = {k: _build.LAUNCHES[k] for k in PACKED_KERNELS}
    log(f"  launches on the packed main path: {dict(_build.LAUNCHES)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"packed main path never launched: {missing}")
    return launches


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--ops", type=int, default=1 << 20)
    ap.add_argument("--packed-capacity", type=int, default=1 << 20)
    ap.add_argument("--packed-ops", type=int, default=1 << 20)
    return ap


def main() -> int:
    args = build_parser().parse_args()

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
    for check in (check_apply_packed, check_packed_round, check_reconcile_packed,
                  check_frontier_packed):
        check(dev, packed_shape, errs, times)
        torch.cuda.empty_cache()
    check_small_sims(dev)
    check_small_packed_sims(dev)
    torch.cuda.empty_cache()

    log(f"phase 4: dense main path, ring {args.peers} x {args.capacity}")
    launches = main_path(args, dev)
    torch.cuda.empty_cache()
    log(f"phase 5: packed main path, ring {args.peers} x {args.packed_capacity}")
    launches.update(packed_main_path(args, dev))

    kernels = []
    for name, (src, rep) in KERNELS.items():
        ms, plain_ms, (bound_ms, bound_by) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes any of these lexicographic
            # multi-key selects
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
