#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (bullet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--peers P] [--capacity N] [--ops K]
                          [--packed-capacity N] [--packed-ops K]
                          [--rank1-capacity N] [--rank1-ops K]
                          [--lean-capacity N] [--lean-ops K]

Phases, in order; any failure raises and exits nonzero:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the kernels of bullet_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, bit-identical (tolerance: exact, the path is all int32), at
   small and ragged shapes, at P = 4096 (where the TPU took its peer-tile
   kernels) and at the main-path shapes, with times per call there; the
   packed-family kernels at each field count (packed, rank, rank1), the
   op apply at 1024 x 2^20 also on the device's clock alone, on shuffled
   ops and at K raw = 2^10, 2^14 and 2^17 (its bound in 32-byte sectors, a
   gather of the same entries and, for rank1, scatter_reduce_ beside it), the
   window join also at rank1 8192 x 2^18 (the TPU's halo-window shape)
   and at the main paths' depths m = 480, 513 and 1024 beside m = 120,
   the whole table's m-round pass at m = 5, 8, 13 and 40 (sweeps, one
   pipelined pass, a pass and sweeps, five passes) at every shape and m = 8
   and 40 at the main shape, m = 8 timed on both clocks,
   the frontiers (dense, lean, packed family) at m = 1 and 8 on rings and
   chains of P in {1, 2, 3, 17, 64, 1000, 4096}, with stripes that settle
   inside a fused step and leave the frontier, the whole ids array
   compared; the column pass against its plain version and the fused
   frontier loop (tables, depth, rounds) on rings and chains of P in {1,
   2, 3, 17, 64, 1000} and the largest P a block holds, seeds all, none,
   one and sparse, and at 1024 x 2^20 on a scatter batch's 49,300 dirty
   columns, 256 and all, timed on both clocks with its bytes; the graph
   pass against its plain version (tables, rounds' depth, every round's
   count) on bridges, stars, a random graph, a digraph, a matrix with holes
   and the 1,024-peer bridge, seeds all and sparse, caps 1, 2, 3 and none,
   and at 1024 x 2^20 on the bridge's 49,300 dirty columns, timed on both
   clocks with its bytes; then small
   dense, packed, rank and rank1 sims on the card against the same sims on
   the CPU; the lean round, the lean frontier and
   the lean merge at 1024 x 2^20 and ragged shapes; the per-shard frontier
   at 256 x 2^18 per shard (reference, lww, lean; m = 1, 8; random and
   zeroed boundary rows); the count fold and compaction of 1 and 4 shards'
   [S, m, t_total] counts, random, all-zero and all-dirty, at S = 4 timed
   on both clocks beside the card's launch floor (an empty kernel) and the
   host's fold it replaces (a zeroed tensor and S adds), with the launches
   of each counted; small lean and sharded sims on the card against the
   CPU; the packed family's per-shard kernels at nf = 3, 2, 1 (the ring
   step m = 1, the fused step m = 8, the window m = 3, 15, 63; random and
   zeroed boundary rows; small, ragged, 1024 x 4096 (the window's row
   tiles) and one 256 x 2^20 shard, timed)
   and the window fold of 1 and 4 shards' stats, random, all-zero and
   all-at-m, timed at S = 4 as the count fold is; the window
   join's shard form (the spmd fast_forward's) at nf = 3, 2, 1 on shards
   of 1 to 17 rows, one past a launch's rows and one 256 x 2^20 shard at
   the spmd passes m = 256 and 224 (random, zeroed and mixed slabs); the
   mesh's column pass (column_summaries, settle_columns) on 4 row slices
   of one table against their plain versions and the one-card pass, on
   rings and chains of 4, 68 and 1024 rows and at 4 x 256 x 2^20 on a
   scatter batch's dirty columns, timed on both clocks with their bytes;
   small packed, rank and rank1 sims on 4 shards on the card against the
   CPU;
4. dense main path: a dense ring PeerNetworkSim at P x N (default
   1024 x 2^18): put_bulk + scalar puts, step, run_until_converged,
   tables_equal, the converged row against an independent numpy lexmax,
   get/get_bulk, more writes applied by step(0), reconcile against a twin
   restored from a snapshot that converges;
5. packed main path: a packed ring PeerNetworkSim at P x N (default
   1024 x 2^20, 12 B/entry, 12.9 GB): put_bulk + string puts, step(1),
   run_until_converged on the packed-frontier-local route (the column
   pass), tables_equal and the converged row against an independent numpy
   per-leaf max, an incremental converge after a second batch, a converge
   capped at the diameter (the fused frontier loop) then finished,
   converged(), a third batch
   and reconcile against a twin restored from a snapshot that reaches the
   fixed point by a blind fast_forward (the window kernel), get/get_bulk;
   then the reference's packed bench cell (bench.py:95-200): its hash
   table, 480 ring rounds as 60 launches of ring_multiround_packed(m = 8)
   against 480 single rounds on a twin, bit-identical, counts equal, with
   the windowed logical merges/s of both;
6. rank1 main path: a rank1 ring PeerNetworkSim at P x N (default
   1024 x 2^20, 4 B/entry, 4.3 GB): put_bulk + string puts, step(1), a
   snapshot restored into two twins, run_until_converged on the
   packed-frontier-local route (the column pass) against an independent
   numpy per-leaf max, fast_forward(480) on one twin against step(480) on
   the other, the jumped twin fast-forwarded to the fixed point against
   the converged table, a converge capped at the diameter (the fused
   frontier loop) then finished, then more writes, reconcile, converged()
   and reads; it prints
   the windowed logical merges/s of fast_forward(480), 2 P N 480 / s;
7. lean main path: a lean dense ring PeerNetworkSim at P x N (default
   1024 x 2^20, 30.1 GB): put_bulk + string/object puts, step(1) (the lean
   round), run_until_converged on the dense-frontier route (lean, m = 8),
   the converged value keys against an independent numpy per-leaf max,
   writer/ctr/tick of sampled rows against what that peer applied itself,
   a second batch, reconcile (the lean doubling join) and reads;
8. sharded dense path: 4 shards of P x N (default 1024 x 2^18) on the one
   card, a full-metadata lww sim and a lean reference sim, each against
   an unsharded twin given the same ops: run_until_converged on the
   dense-frontier-spmd route (m = 8), all 7 fields, rounds and residuals
   bit-identical; a cutoff converge (fused step + single-round tail),
   reconcile and reads; the lww pair also step(1) and converged(); then,
   untimed, one more cutoff converge with its launches per mesh step
   counted (port kernels and PyTorch operators);
9. the packed family on a mesh: 4 shards of P x N (default 1024 x 2^20)
   on the one card, each sim against an unsharded twin given the same
   ops. Packed (12.9 GB + the twin): step(1) (the per-shard apply and ring
   round), run_until_converged on packed-frontier-spmd (one column pass a
   shard) against packed-frontier-local, a 2^16 batch cut off at 70
   rounds (one window of 63 rounds per exchange and a 7-round tail),
   converged(), reconcile and reads, then, untimed, one more cutoff
   converge with its launches per mesh step counted. Rank1 (4.3 GB): a
   converge by the column pass a shard, a
   restored copy converged by gossip_frontier_shardmap_packed with
   fuse=HALO_FUSE, and fast_forward(480) (the spmd route: the window
   join's shard form, two passes) against
   step(480) on the twin, with its windowed logical merges/s;
10. the queries: records shaped as the upstream query fixture (users,
   products, leaf-form scores; about 29 N / 32 paths) written at random peers,
   some fields again from others, on packed and rank1 sims at P x N
   (default 1024 x 2^20), a dense sim at 1024 x 2^18 and a 4-shard packed
   mesh on the one card beside its unsharded twin; after step(1) and after
   the converge, equals, range, count (field and leaf forms), filter,
   find and count with Predicates, and a SimPeer call at peers 0, P/2 and
   P - 1, each held exactly against a host oracle (``get`` of the
   subtree, then ``Predicate.evaluate`` in Python) and the twin; each
   query's host-inclusive ms, its PyTorch operators, the oracle's get +
   scan ms and the row's byte bound are printed;
11. batch ingress, the earlier phases' sims freed: the two schemas of
   examples/validation_example.py (bullet-js's validation example) bound
   to users and products, records of phase 10's shape (2^17 users, 2^15
   products at random peers) with a known share of values that break
   them (ages out of range, non-integral or boolean, roles outside the
   enum, strings in verified, usernames of bad length, negative prices;
   and 1% second ages at the same peer that would win were they not
   vetoed). A packed 1024 x 2^20 sim with the schemas beside a twin given
   only the ops an independent Python oracle keeps: ops_rejected and the
   error handler's count equal to the oracle's, tables exact after
   step(1), the converge and reconcile, reads. A rank1 1024 x 2^20 sim
   with a traced put transform in torch that caps prices at 1000 beside a
   twin given the capped values. A dense 1024 x 2^18 sim with host hooks
   (a put hook that vetoes secret/... and rewrites alias/..., afterPut and
   "write" counters, a get hook and an afterGet transform), scalar and
   bulk puts against Python's expected results. A 4-shard rank1 mesh with
   the schemas beside its unsharded twin. Each prints put_bulk's host
   seconds, step(1) against the twin's, the ingress round trip and
   report_rejections;
12. the serving path, the earlier phases' sims freed: two port Bullets
   on 127.0.0.1 (a serving and a writer peer), the serving one mirrored
   by attach_live_bridge into a rank1 P x N ring (default 1024 x 2^20)
   preloaded at peer 0 with phase 10's records and converged;
   warm_apply_buckets(2^16); benchmarks/serving_bench.py's flood (4000
   records over TCP: writes/s), the mirror lag (the first count through
   the view, exact), idle p50/p95 of equals, range and count over 60
   rounds, loaded p50/p95/p99 of count under a writer thread's price
   overwrites (paced, beside the reference's 50 ms p95 bound, which is
   not asserted); the counts, ranges (against scans of the serving
   store, and after the load of the maxima the mirror keeps) and the
   store exact, flush() converging every peer; sim_from_bullet of the
   serving store, its dump into a fresh Bullet, export_to_json, CSV and
   XML imports into a rank1 sim, each against the serving Bullet; a
   StepObserver's summary and a profile_trace of one converge that must
   hold the port's kernels; checkpoint round trips of packed and rank1
   P x 2^16 (phase 10's records cut to a sixteenth) on the card: tables
   bit-equal (rank1: the value ids), reads, a second batch converged
   alike, the packed one also loaded onto 4 shards against the
   unsharded load; save and load seconds and bytes on disk;
13. the mesh across processes (``parallel/multihost.py``): the script
   starts two processes of itself (``--mesh-process``), each joining a
   gloo process group and owning two of four shards on cuda:0 (NCCL
   refuses two processes on one card). In each, beside unsharded twins
   given the same ops: the packed P x N (default 1024 x 2^20) ring's
   step(1), converge on packed-frontier-spmd (one column pass a shard,
   the shards' summaries summed between the processes through pinned host
   memory), a 2^16 batch cut off at 70 rounds (windows of 63 rounds, their
   slabs sent between the processes), converged(), reconcile and reads at peers
   of both processes; rank1's spmd fast_forward(480) against step(480),
   then a HALO_FUSE converge; the dense lww 1024 x 2^18 ring's step(1),
   converge on dense-frontier-spmd and a cutoff. Each process holds its
   own shards exactly against its twin's rows; both processes' returned
   values, round counts, residuals and applied counts must be equal; each
   logs its windows' wall seconds, the bytes it sent and received per mesh
   step, the exchange's host seconds beside its kernels' CUDA-event
   seconds. Then one process under NCCL, a world of one with four shards
   on cuda:0, runs the packed path through the same code (its fold and
   reconcile sums are NCCL all-reduces of card tensors). A process that
   fails gets the others killed; the script fails with it.
14. the bridge deployment (bullet-js's bridge example at 204 full-mesh
   clusters of 5 joined through 4 bridge peers, P = 1,024; packed, N
   default 2^20): put_bulk, step(0) and run_until_converged through the
   graph pass, one launch a converge and no plain round, the converged row
   against an independent numpy per-leaf max; an incremental converge of
   a second batch (its dirty columns alone); a converge capped at 2 rounds
   then finished; step(2) of a third batch; converged().

Every kernel's launch count over the phase that drives its path (4 for
the dense kernels, 5 and 6 for the packed-family ones, 5 for the m-round
pass, 7 for the lean
ones, 8 for the sharded ones, 9 for the packed family's mesh kernels; 10
checks the kernels its step(1) and converges run, 11 those each of its
sims drives, 12 the apply, the frontiers and the count-only round of its
serving path, 13 in every process the per-shard kernels, folds, apply and
reconcile of its mesh sims) must be > 0. The last
two lines are a JSON
object describing the kernels and the contract line
{"ok": true, "device": {...}}. Imports nothing of JAX."""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
import time

from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
        "bullet_tpu/ops/packed.py:948; bullet_tpu/ops/packed.py:1286; "
        "bullet_tpu/ops/packed.py:2990",
    ),
    "packed_round fused": (
        "bullet_tpu_torch/csrc/packed_round.cu", "bullet_tpu/ops/packed.py:967",
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
    "window_shard": (
        "bullet_tpu_torch/csrc/window_packed.cu", "bullet_tpu/ops/packed.py:1969",
    ),
    "ring_round_lean": (
        "bullet_tpu_torch/csrc/ring_round.cu",
        "bullet_tpu/ops/ring_kernel.py:146; bullet_tpu/ops/ring_kernel.py:185",
    ),
    "frontier_shard": (
        "bullet_tpu_torch/csrc/frontier_shard.cu", "bullet_tpu/ops/ring_kernel.py:552",
    ),
    "frontier_shard fused": (
        "bullet_tpu_torch/csrc/frontier_shard.cu", "bullet_tpu/ops/ring_kernel.py:702",
    ),
    "compact_counts": (
        "bullet_tpu_torch/csrc/compact_counts.cu", "bullet_tpu/ops/packed.py:2463",
    ),
    "compact_counts fused": (
        "bullet_tpu_torch/csrc/compact_counts.cu", "bullet_tpu/ops/packed.py:2681",
    ),
    "frontier_shard packed": (
        "bullet_tpu_torch/csrc/frontier_shard.cu", "bullet_tpu/ops/packed.py:1560",
    ),
    "frontier_shard packed fused": (
        "bullet_tpu_torch/csrc/frontier_shard.cu", "bullet_tpu/ops/packed.py:2585",
    ),
    "frontier_shard_window": (
        "bullet_tpu_torch/csrc/frontier_shard_window.cu", "bullet_tpu/ops/packed.py:2808",
    ),
    "compact_counts window": (
        "bullet_tpu_torch/csrc/compact_counts.cu", "bullet_tpu/ops/packed.py:2900",
    ),
    # the port's own: an uncapped converge's dirty columns in one pass, where
    # the reference runs its frontier loop (bullet_tpu/ops/packed.py:2161)
    "converge_columns": ("bullet_tpu_torch/csrc/converge_columns.cu", "none"),
    # the port's own: an uncapped mesh converge's dirty columns in one pass a
    # shard about one gather, where the reference runs its window frontier
    # (bullet_tpu/ops/packed.py:2808, #25)
    "column_summaries": ("bullet_tpu_torch/csrc/converge_columns_shard.cu", "none"),
    "settle_columns": ("bullet_tpu_torch/csrc/converge_columns_shard.cu", "none"),
    # the port's own: any topology's rounds on the dirty columns in one
    # pass, where the reference runs its whole-table round loop
    # (bullet_tpu/ops/packed.py:917)
    "converge_graph": ("bullet_tpu_torch/csrc/converge_graph.cu", "none"),
}
DENSE_KERNELS = ("merge", "ring_round", "frontier_round_dense")
# the packed-family kernels: phase 5 drives them at nf = 3, phase 6 at nf = 1;
# phase 5's fused rounds window also the m-round pass
PACKED_KERNELS = ("apply_packed", "packed_round", "reconcile_packed", "frontier_round_packed",
                  "window_packed", "converge_columns")
FUSED_ROUNDS = "packed_round fused"
# phase 7 drives the lean round, the dense frontier at nf = 4 and the lean
# merge; phase 8 the per-shard frontier and the count compaction, each
# single-round (the cutoff's tail) and fused
LEAN_KERNELS = ("ring_round_lean", "frontier_round_dense", "merge")
SHARD_KERNELS = ("frontier_shard", "frontier_shard fused", "compact_counts",
                 "compact_counts fused")
# phase 9 drives the packed family's per-shard kernels: the packed sim the
# ring round (m = 1), the column pass a shard (its uncapped converge), the
# window and its fold (the cutoff); the rank1 sim the column pass, its copy
# the fused frontier (m = 8), the rank1 spmd fast_forward the window join's
# shard form
MESH_PACKED_KERNELS = ("frontier_shard packed", "frontier_shard packed fused",
                       "frontier_shard_window", "compact_counts window", "window_shard",
                       "column_summaries", "settle_columns")
# phases 8 and 9's mesh: this many shards, all on the one card
SHARDS = 4

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


# P of the frontier checks (ring and chain, m = 1 and 8): tiny rings where
# the pipelined pass's 2 m extension rows are copies of rows taken mod P,
# 17 (P > 2 m), and the big-P shapes
FRONTIER_PS = (1, 2, 3, 17, 64, 1000, 4096)
FRONTIER_WIDTH = {1: 64, 2: 64, 3: 96, 17: 96, 64: 2048, 1000: 512, 4096: 256}
# an entry that beats every random one of its layout, by field count (7
# dense, 4 lean keys, 3 packed, 2 rank, 1 rank1)
TOP = {7: (9,) * 7, 4: (9,) * 4, 3: (9, 9, (5 << 28) | 9), 2: (100, (1 << 28) | 100),
       1: (100,)}


def settling(table, tile: int, nf: int):
    """A copy of ``table`` whose even stripes hold TOP outside rows 5..9:
    they settle in round 3 of a fused step (row 7 last), so their last
    changed round is below 8 and they leave the frontier; the odd stripes
    keep changing (P >= 17)."""
    out = clone(table)
    n = out[0].shape[1]
    for s0 in range(0, n, 2 * tile):
        for f, v in zip(out[:nf], TOP[nf]):
            f[:5, s0:s0 + tile] = v
            f[10:, s0:s0 + tile] = v
    return out


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
    for p in FRONTIER_PS:
        n = FRONTIER_WIDTH[p]
        tile = frontier_tile_n(n)
        t_total = n // tile
        table = random_table(200 + p, p, n, dev)
        cases = [(table, m, dirty) for m in (1, 8)
                 for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4)]
        if p >= 17:
            cases.append((settling(table, tile, 7), 8, np.ones(t_total, bool)))
        for (base, m, dirty), wrap, mode in itertools.product(
                cases, (True, False), ("reference", "lww")):
            e = _frontier_pair(base, _ids(dirty, m, dev), tile, wrap, mode, m)
            errs["frontier_round_dense"] = max(errs["frontier_round_dense"], e)
            if e:
                raise AssertionError(
                    f"frontier p={p} n={n} m={m} wrap={wrap} {mode}: max_abs_err {e}")
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
# the window depths the main paths run on the 1024-ring: m = 120, phase 6's
# fast_forward(480) and its jump to the fixed point (1024), phase 5's twin
# jump (513)
MAIN_WINDOW_DEPTHS = (120, 480, 513, 1024)


def spmd_passes(p: int, b: int):
    """The window passes of phase 9's spmd fast_forward(min(480, P/2 - 1))
    on shards of b rows: at most b rounds each (256 and 224 at the default
    1024 peers on 4 shards)."""
    passes, left = [], min(480, p // 2 - 1)
    while left > 0:
        passes.append(min(left, b))
        left -= passes[-1]
    return tuple(passes)


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


# a spin of about 3 ms at the H100's clock, queued ahead of a timed call so
# that the host has enqueued all of the call before the device reaches it
SPIN_CYCLES = 5_000_000


# a write this large leaves nothing of a call's inputs in the 50 MB L2
FLUSH_BYTES = 256 << 20


def flush_l2():
    torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda").zero_()


def device_once(fn):
    """(fn(), ms): one call's device time, CUDA events behind a spin kernel:
    unlike ``timed_once`` it leaves out the host's time to enqueue the call,
    which the device would otherwise wait for (about 0.1 ms for the apply's
    wrapper, as long as its kernel). A 256 MB write first flushes the L2,
    so the call finds its inputs in device memory, as a main path's call
    does after work over a whole table."""
    flush_l2()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def apply_sector_bound(table, ops, nf: int):
    """Bound of applying ``ops`` to ``table`` as it is now, in 32-byte
    sectors (the least a scattered access moves), counting what these ops
    need: the op rows read once; for the live in-range ops, each distinct
    sector of the entry planes their compares need read once (the most
    significant key's plane: the packed cv, the rank; the packed khi only
    where the classes tie, klo only where khi ties too); each distinct
    sector of the entries that land written once a field; a compare and a
    select a field an op."""
    from bullet_tpu_torch.ops.packed import CV_SHIFT, op_present, packed_beats

    p, n = table[0].shape
    peer, slot = ops[0].to(torch.int64), ops[1].to(torch.int64)
    inside = (peer >= 0) & (peer < p) & (slot >= 0) & (slot < n)
    flat = (peer * n + slot)[inside]
    vals = [v[inside] for v in ops[2:]]
    cur = [f.view(-1)[flat] for f in table]
    live = op_present(vals)
    lands = live & packed_beats(vals, cur)
    needed = [live]
    if nf == 3:
        needed.append(live & (vals[2] >> CV_SHIFT == cur[2] >> CV_SHIFT))
        needed.append(needed[-1] & (vals[0] == cur[0]))
    sectors = sum(torch.unique(flat[m] >> 3).numel() for m in needed)
    sectors += nf * torch.unique(flat[lands] >> 3).numel()
    return bound(4 * ops.numel() + 32 * sectors, 2 * nf * ops.shape[1])


# raw op counts of the apply's K sweep at the main shape, beside its batch of
# 2^20 (each reduced to unique (peer, slot) pairs on the host)
APPLY_SWEEP = (1 << 10, 1 << 14, 1 << 17)


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
    # the main shape: one call each on identical tables, timed as every row
    # is (the warm-up calls on a small table keep first-use costs out of
    # the times); then the same call on a fresh table on the device's clock
    # alone, the yardsticks on both clocks, and, on the tables as the batch
    # left them, a shuffled batch and the K sweep
    p, n = main_shape
    ops = _random_ops(rng, p, n, 1 << 20, dev, nf)
    k = ops.shape[1]
    small, small_ops = random_family(nf, 6, 8, 4096, dev), _random_ops(rng, 8, 4096, 64, dev, nf)
    apply_flat_packed(clone(small), small_ops)
    apply_flat_packed_torch(small, small_ops)
    table = random_family(nf, 5, p, n, dev)
    (_, wins), ms = timed_once(lambda: apply_flat_packed(table, ops))
    twin = random_family(nf, 5, p, n, dev)
    # reckoned on the twin before its apply, then the L2 flushed: its
    # gathers leave the entries the ops touch in L2
    row_bound = apply_sector_bound(twin, ops, nf)
    flush_l2()
    (_, want_wins), plain = timed_once(lambda: apply_flat_packed_torch(twin, ops))
    _pair("apply_packed", errs, (*table, wins), (*twin, want_wins), f"nf={nf} {p}x{n} K={k}")
    wins = int(wins)
    del table
    table = random_family(nf, 5, p, n, dev)
    flat = ops[0].to(torch.int64) * n + ops[1].to(torch.int64)
    planes = [f.view(-1) for f in table]
    # each call cold: the L2 flushed first, as device_once does
    clocks = (("host", lambda fn: (flush_l2(), timed_once(fn))[1]), ("device", device_once))
    gather = {clock: timer(lambda: [f.index_select(0, flat) for f in planes])[1]
              for clock, timer in clocks}
    library = {}
    if nf == 1:
        # the rank1 table result (not the count) by one PyTorch call, on a
        # copy of the entries the ops touch, put back after each call
        saved = planes[0][flat].clone()
        for clock, timer in clocks:
            library[clock] = timer(
                lambda: planes[0].scatter_reduce_(0, flat, ops[2], "amax"))[1]
            planes[0].index_copy_(0, flat, saved)
        del saved
    (_, c_dev), device_ms = device_once(lambda: apply_flat_packed(table, ops))
    _pair("apply_packed", errs, (*table, c_dev), (*twin, want_wins),
          f"nf={nf} {p}x{n} K={k} device-timed")
    shuffled = _random_ops(rng, p, n, 1 << 20, dev, nf)
    shuffled = shuffled[:, torch.from_numpy(rng.permutation(shuffled.shape[1])).to(dev)]
    batches = [("shuffled", shuffled.contiguous())]
    batches += [(f"K raw {raw}", _random_ops(rng, p, n, raw, dev, nf)) for raw in APPLY_SWEEP]
    sweep = []
    for what, batch in batches:
        (_, c_got), t = device_once(lambda: apply_flat_packed(table, batch))
        _, c_want = apply_flat_packed_torch(twin, batch)
        _pair("apply_packed", errs, (*table, c_got), (*twin, c_want),
              f"nf={nf} {p}x{n} {what} K={batch.shape[1]}")
        sweep.append(f"{what} K={batch.shape[1]} {t:.4f}")
    del table, twin, planes
    # ms and library_ms on the host-inclusive clock of every row; the
    # device-alone times under keys of their own
    extra = {"device_ms": device_ms}
    if library:
        extra.update(library_call="scatter_reduce_ amax: table only, no count",
                     library_device_ms=library["device"])
    times[tag("apply_packed", nf)] = (ms, plain, row_bound, library.get("host"), extra)
    log(f"  apply_packed [{LAYOUT_OF[nf]}] {p}x{n}, K = {k} unique ops, {wins} land: kernel "
        f"{ms:.4f} ms (one call, host-inclusive), {device_ms:.4f} ms (device alone), plain "
        f"{plain:.3f} ms, sector bound {row_bound[0]:.4f} ms, gather of the entries "
        f"{gather['host']:.4f} / {gather['device']:.4f} ms"
        + (f", scatter_reduce_ amax {library['host']:.4f} / {library['device']:.4f} ms "
           "(table only, no count)" if library else "")
        + f" (host-inclusive / device alone); then on the device alone {', '.join(sweep)} ms; "
        f"bit-identical at {len(PACKED_SHAPES) + 6} shapes and clocks")


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


# the depths the m-round pass is held at: five sweeps, one pipelined pass,
# a pass and five sweeps, five passes (the reference's stripe_fuse depths
# are 8, 5 and 40)
FUSED_DEPTHS = (5, 8, 13, 40)
# and the rings it is held at besides PACKED_SHAPES': shorter than the
# pass's 16 extension rows and just past them, on a ragged stripe
FUSED_PS, FUSED_N = (2, 9, 16, 17), 300


def check_packed_round(dev, main_shape, errs, times, nf):
    from bullet_tpu_torch.ops import packed as pk

    for p, n in PACKED_SHAPES:
        base = random_family(nf, 400 + p, p, n, dev)
        for wrap in (True, False):
            for m in (1, *FUSED_DEPTHS):
                got, c_got = pk.ring_multiround_packed(clone(base), wrap, m)
                want, c_want = pk.packed_round_torch(clone(base), wrap, m)
                _pair("packed_round" if m == 1 else FUSED_ROUNDS, errs, (*got, c_got),
                      (*want, c_want), f"nf={nf} {p}x{n} wrap={wrap} m={m}")
            c_got = pk.count_changes_round_packed(base, wrap)
            _, c_want = pk.packed_round_torch(clone(base), wrap, 1, count_only=True)
            _pair("packed_round", errs, c_got, c_want, f"nf={nf} {p}x{n} wrap={wrap} count-only")
        del base
    for p in FUSED_PS:
        base = random_family(nf, 450 + p, p, FUSED_N, dev)
        for wrap, m in itertools.product((True, False), FUSED_DEPTHS):
            got, c_got = pk.ring_multiround_packed(clone(base), wrap, m)
            want, c_want = pk.packed_round_torch(clone(base), wrap, m)
            _pair(FUSED_ROUNDS, errs, (*got, c_got), (*want, c_want),
                  f"nf={nf} {p}x{FUSED_N} wrap={wrap} m={m}")
    # the main shape: the kernel on one table, the plain version on an
    # identical twin; each call leaves the two equal again for the next
    # (m = 40: five passes, their counts summed in one int32)
    p, n = main_shape
    table, twin = random_family(nf, 7, p, n, dev), random_family(nf, 7, p, n, dev)
    plain = {}
    for what, wrap, m, count_only in (("chain", False, 1, False), ("ring", True, 1, False),
                                      ("count-only", True, 1, True), ("m=8", True, 8, False),
                                      ("m=40", True, 40, False)):
        if count_only:
            got = (pk.count_changes_round_packed(table, wrap),)
        else:
            got = (*table, pk.ring_multiround_packed(table, wrap, m)[1])
        (_, c_want), plain[what] = timed_once(
            lambda: pk.packed_round_torch(twin, wrap, m, count_only))
        _pair("packed_round" if m == 1 else FUSED_ROUNDS, errs, got,
              (c_want,) if count_only else (*twin, c_want), f"nf={nf} {p}x{n} {what}")
    del twin
    ms = time_ms(lambda: pk.ring_round_packed(table, True), 5)
    probe = time_ms(lambda: pk.count_changes_round_packed(table, True), 5)
    fused = time_ms(lambda: pk.ring_multiround_packed(table, True, 8), 2)
    _, fused_dev = device_once(lambda: pk.ring_multiround_packed(table, True, 8))
    del table
    times[tag("packed_round", nf)] = (ms, plain["ring"], round_bound(nf, p * n))
    times[tag("packed_round count-only", nf)] = (probe, plain["count-only"], probe_bound(nf, p * n))
    # one read and one write of the table whatever m: the pipelined pass
    # keeps a column's rows on chip between its 8 rounds
    times[tag(FUSED_ROUNDS, nf)] = (fused, plain["m=8"], round_bound(nf, p * n, rounds=8), None,
                                    {"device_ms": fused_dev})
    log(f"  packed_round [{LAYOUT_OF[nf]}] {p}x{n}: kernel {ms:.3f} ms, plain "
        f"{plain['ring']:.3f} ms per round; count-only {probe:.3f} ms (plain "
        f"{plain['count-only']:.3f}); m=8 (one pipelined pass) {fused:.3f} ms, device alone "
        f"{fused_dev:.3f} ms (plain {plain['m=8']:.3f}, bound "
        f"{times[tag(FUSED_ROUNDS, nf)][2][0]:.3f}) per call; ring, chain, count-only, m=8 and "
        f"m=40 bit-identical, and m = 1, {', '.join(map(str, FUSED_DEPTHS))} at "
        f"{len(PACKED_SHAPES)} shapes and P = {FUSED_PS} x {FUSED_N}")


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
        ms, plain, bound(4 * (key_fields(nf) + nf) * p * n, (2 * nf + 1) * p * n)) + (
        (library, {"library_call": "torch.amax + copy_"}) if library is not None else ())
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
    for p in FRONTIER_PS:
        n = FRONTIER_WIDTH[p]
        tile = pk.frontier_tile_n(n)
        t_total = n // tile
        base = random_family(nf, 600 + p, p, n, dev)
        for m in (1, 8):
            for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4):
                for wrap in (True, False):
                    pair(clone(base), clone(base), _ids(dirty, m, dev), tile, wrap, m,
                         f"{p}x{n} m={m} wrap={wrap} dirty={int(dirty.sum())}/{t_total}")
        if p >= 17:
            calm = settling(base, tile, nf)
            for wrap in (True, False):
                left = pair(clone(calm), clone(calm), _ids(np.ones(t_total, bool), 8, dev), tile,
                            wrap, 8, f"{p}x{n} m=8 wrap={wrap} settling")[0]
                if left > t_total // 2:
                    raise AssertionError(f"frontier_round_packed nf={nf} {p}x{n}: {left} of "
                                         f"{t_total} stripes kept, the settled ones among them")
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
    plain, report = {}, []
    for what, ids, m in steps:
        active = int(ids[t_total])
        survivors, ms = pair(table, twin, ids, tile, True, m, f"{p}x{n} {what}")
        plain.setdefault(m, ms)
        report.append(f"{what}: {active} -> {survivors} stripes")
    plain, plain_m1 = plain[8], plain[1]
    del twin
    ms = time_ms(lambda: pk.frontier_round_packed(table, full, tile, True, 8), 3)
    # #20 alone: one round over all stripes
    one = _ids(np.ones(t_total, bool), 1, dev)
    ms1 = time_ms(lambda: pk.frontier_round_packed(table, one, tile, True, 1), 3)
    del table
    # one read and one write of the table whatever m (see packed_round fused)
    times[tag("frontier_round_packed", nf)] = (ms, plain, round_bound(nf, p * n, rounds=8))
    times[tag("frontier_round_packed m=1", nf)] = (ms1, plain_m1, round_bound(nf, p * n))
    log(f"  frontier_round_packed [{LAYOUT_OF[nf]}] {p}x{n} tile {tile}, m=8, all {t_total} "
        f"stripes: kernel {ms:.3f} ms, plain {plain:.3f} ms per call; m=1 kernel {ms1:.3f} ms, "
        f"plain {plain_m1:.3f} ms; bit-identical ({'; '.join(report)})")


# P x N of the column pass's checks: tiny rings and chains, 17 and 1000
# rows (ragged 32-row words), and the largest P a block holds packed and
# rank1 (each layout skips the shapes past its own)
COLUMN_SHAPES = ((1, 64), (2, 64), (3, 256), (17, 512), (64, 1024), (1000, 512), (1087, 256),
                 (2784, 256))
# the main shape's seeds: the scatter cells' dirty columns a batch (about
# 49,300 of 2^20) and the read cells' (a few hundred)
SCATTER_COLUMNS, READ_COLUMNS = 49_300, 256


def column_seed(rng, n: int, kind: str):
    """Dirty columns bool [n] of a seed kind, or None for every column."""
    if kind == "all":
        return None
    dirty = np.zeros(n, dtype=bool)
    count = {"none": 0, "one": 1, "sparse": max(1, n // 20), "scatter": SCATTER_COLUMNS,
             "read": READ_COLUMNS}[kind]
    dirty[rng.choice(n, min(n, count), replace=False)] = True
    return dirty


def dirtied(nf: int, seed: int, p: int, n: int, dirty, wrap: bool, dev, win: bool = False):
    """A table for the column pass at a seed: with every column dirty a
    random one; else a random table at its fixed point (a ring's by the
    reconcile kernel; a chain's, whose ends pull up entries below the
    all-zero one, by the frontier loop), then 1 to 3 random rows of each
    dirty column given a random table's entry (some win, some tie, some
    lose); with ``win`` the first of them TOP, which beats every other, as
    a write that wins its leaf at one peer. Deterministic in its
    arguments."""
    from bullet_tpu_torch.ops import packed as pk

    table = random_family(nf, seed, p, n, dev)
    if dirty is None:
        return table
    if wrap:
        pk.reconcile_packed(table)
    else:
        tile = pk.frontier_tile_n(n)
        pk.gossip_frontier_packed(table, torch.ones(n // tile, dtype=torch.bool, device=dev),
                                  False, 2 * p + 2, fuse=pk.STRIPE_FUSE, tile_n=tile)
    rng = np.random.default_rng(seed)
    cols = np.flatnonzero(dirty)
    rows = rng.integers(0, p, (3, cols.size))
    # about half the columns take fewer rows: a repeated row writes once
    again = rng.random((2, cols.size)) < 0.5
    rows[1:][again] = np.broadcast_to(rows[0], (2, cols.size))[again]
    src = random_family(nf, seed + 1, p, n, dev)
    r = torch.from_numpy(rows.reshape(-1)).to(dev)
    c = torch.from_numpy(np.tile(cols, 3)).to(dev)
    for f, s in zip(table, src):
        f[r, c] = s[r, c]
    if win:
        first, c = r[:cols.size], c[:cols.size]
        for f, v in zip(table, TOP[nf]):
            f[first, c] = v
    return table


def stripe_seed_of(dirty, n: int, tile: int, dev) -> torch.Tensor:
    if dirty is None:
        return torch.ones(n // tile, dtype=torch.bool, device=dev)
    return torch.from_numpy(dirty.reshape(n // tile, tile).any(1)).to(dev)


def column_pass_sectors(before, after, dirty, p: int, nf: int):
    """(bytes the pass moves, its floor in 32-byte sectors): the kernel
    reads every row of each 16-column group and writes back whole the
    group's rows that hold a changed entry; the floor reads every row's
    sector (8 columns) that holds a dirty column and writes every sector
    that holds a changed entry."""
    from bullet_tpu_torch.ops.packed import COLUMN_GROUP, column_groups

    n = before[0].shape[1]
    changed = None
    for a, b in zip(before, after):
        d = a != b
        changed = d if changed is None else changed | d
    rows = int(changed.view(p, -1, COLUMN_GROUP).any(2).sum())
    sectors = int(changed.view(p, -1, 8).any(2).sum())
    dirty_sectors = n // 8 if dirty is None else int(dirty.reshape(-1, 8).any(1).sum())
    moved = 4 * COLUMN_GROUP * nf * (len(column_groups(dirty, n)) * p + rows)
    return moved, 32 * nf * (dirty_sectors * p + sectors)


def check_converge_columns(dev, main_shape, errs, times, nf):
    """The column pass against its plain version and against the fused
    frontier loop (#19/#20) it replaces where no cap binds: tables, depth
    and round count, on rings and chains."""
    from bullet_tpu_torch.ops import packed as pk

    def pair(table, dirty, wrap, what):
        """The kernel on ``table``, the plain version and the frontier loop
        on copies; returns (rounds, plain ms)."""
        p, n = table[0].shape
        twin, loop = clone(table), clone(table)
        _, depth = pk.converge_columns_packed(table, dirty, wrap)
        groups = torch.from_numpy(pk.column_groups(dirty, n)).to(dev)
        want, plain = timed_once(lambda: pk.converge_columns_packed_torch(twin, groups, wrap))
        _pair("converge_columns", errs, (*table, depth.cpu()), (*twin, want), f"nf={nf} {what}")
        del twin
        tile = pk.frontier_tile_n(n)
        cap = max(p // 2 if wrap else p - 1, 1) + 1
        _, rounds, left = pk.gossip_frontier_packed(loop, stripe_seed_of(dirty, n, tile, dev),
                                                    wrap, cap, fuse=pk.STRIPE_FUSE, tile_n=tile)
        _pair("converge_columns", errs, (*table, torch.tensor([int(depth) + 1, 0])),
              (*loop, torch.tensor([rounds, left])), f"nf={nf} {what} against the frontier loop")
        return rounds, plain

    rng = np.random.default_rng(30 + nf)
    for p, n in COLUMN_SHAPES:
        if not pk.column_pass_fits(p, n, nf):
            continue
        for kind, wrap in itertools.product(("all", "none", "one", "sparse"), (True, False)):
            dirty = column_seed(rng, n, kind)
            pair(dirtied(nf, 700 + p, p, n, dirty, wrap, dev, win=kind == "one"), dirty, wrap,
                 f"{p}x{n} wrap={wrap} seed={kind}")
    p, n = main_shape
    report, row = [], None
    for kind in ("scatter", "read", "all"):
        dirty = column_seed(rng, n, kind)
        n_groups = len(pk.column_groups(dirty, n))
        rounds, plain = pair(dirtied(nf, 31, p, n, dirty, True, dev, win=True), dirty, True,
                             f"{p}x{n} {kind}")
        before = dirtied(nf, 31, p, n, dirty, True, dev, win=True)
        after = clone(before)
        _, ms = timed_once(lambda: pk.converge_columns_packed(after, dirty, True))
        moved, sectors = column_pass_sectors(before, after, dirty, p, nf)
        del after
        _, dev_ms = device_once(lambda: pk.converge_columns_packed(before, dirty, True))
        del before
        cols = n if dirty is None else int(dirty.sum())
        report.append(f"{kind} ({cols} columns, {n_groups} groups, {rounds} rounds): kernel "
                      f"{ms:.3f} ms, device alone {dev_ms:.3f} ms, plain {plain:.3f} ms, "
                      f"{moved / 1e9:.3f} GB moved, sector bound {bound(sectors, 0)[0]:.3f} ms")
        if kind == "scatter":
            row = (ms, plain, bound(sectors, 0), None,
                   {"device_ms": dev_ms, "bytes": moved, "columns": cols, "groups": n_groups})
        torch.cuda.empty_cache()
    times[tag("converge_columns", nf)] = row
    log(f"  converge_columns [{LAYOUT_OF[nf]}] {p}x{n}, ring: {'; '.join(report)}; "
        f"bit-identical to its plain version and the frontier loop, and at "
        f"{len(COLUMN_SHAPES)} shapes, rings and chains, seeds all, none, one, sparse")


# P x N of the mesh column pass's checks, four shards each: one row a
# shard, 17-row shards (ragged 32-row words), and phase 9's shard
SHARD_COLUMN_SHAPES = ((4, 64), (68, 512), (1024, 256))


def check_columns_shard(dev, main_shape, errs, times, nf):
    """The mesh's column pass (``column_summaries``, the gather as a plain
    stack of the shards' summaries, ``settle_columns``) on ``SHARDS`` row
    slices of one table: each kernel against its plain version, and the
    settled table and round count against the one-card pass
    (``converge_columns_packed``, held against the frontier loop by
    ``check_converge_columns``), on rings and chains."""
    from bullet_tpu_torch.ops import packed as pk

    def shards(table):
        b = table[0].shape[0] // SHARDS
        return [type(table)(*(f[i * b:(i + 1) * b] for f in table)) for i in range(SHARDS)]

    def summaries(table, ids, plain=False):
        n_groups = ids.numel() - 1
        out = torch.zeros((SHARDS, n_groups, pk.COLUMN_GROUP, nf + pk.SUMMARY_RUN_WORDS),
                          dtype=torch.int32, device=dev)
        fn = pk.column_summaries_torch if plain else pk.column_summaries
        for i, shard in enumerate(shards(table)):
            fn(shard, ids[:-1], out[i])
        return out

    def pair(table, dirty, wrap, what):
        n = table[0].shape[1]
        groups = pk.column_groups(dirty, n)
        if groups.size == 0:
            return
        ids = torch.from_numpy(np.append(groups, np.int32(0))).to(dev)
        twin, one = clone(table), clone(table)
        sums = summaries(table, ids)
        _pair("column_summaries", errs, sums, summaries(table, ids, plain=True),
              f"nf={nf} {what}")
        cells = [ids.clone() for _ in range(2)]
        for i, (mine, theirs) in enumerate(zip(shards(table), shards(twin))):
            pk.settle_columns(mine, cells[0], sums, i, wrap)
            pk.settle_columns_torch(theirs, cells[1], sums, wrap)
        _, depth = pk.converge_columns_packed(one, dirty, wrap)
        _pair("settle_columns", errs, (*table, cells[0][-1:].cpu()),
              (*twin, cells[1][-1:].cpu()), f"nf={nf} {what}")
        _pair("settle_columns", errs, (*table, cells[0][-1:].cpu()), (*one, depth[None].cpu()),
              f"nf={nf} {what} against the one-card pass")

    rng = np.random.default_rng(40 + nf)
    for p, n in SHARD_COLUMN_SHAPES:
        for kind, wrap in itertools.product(("all", "one", "sparse"), (True, False)):
            dirty = column_seed(rng, n, kind)
            pair(dirtied(nf, 800 + p, p, n, dirty, wrap, dev, win=kind == "one"), dirty, wrap,
                 f"{p}x{n} wrap={wrap} seed={kind}")
        torch.cuda.empty_cache()
    p, n = main_shape
    b = p // SHARDS
    dirty = column_seed(rng, n, "scatter")
    table = dirtied(nf, 41, p, n, dirty, True, dev, win=True)
    pair(table, dirty, True, f"{p}x{n} scatter")
    table = dirtied(nf, 41, p, n, dirty, True, dev, win=True)
    groups = pk.column_groups(dirty, n)
    ids = torch.from_numpy(np.append(groups, np.int32(0))).to(dev)
    sums = summaries(table, ids)
    shard = shards(table)[1]
    read = groups.size * b * 4 * pk.COLUMN_GROUP * nf
    ms = timed_once(lambda: pk.column_summaries(shard, ids[:-1], sums[1]))[1]
    dev_ms = device_once(lambda: pk.column_summaries(shard, ids[:-1], sums[1]))[1]
    plain = timed_once(lambda: pk.column_summaries_torch(shard, ids[:-1], sums[1]))[1]
    times[tag("column_summaries", nf)] = (ms, plain, bound(read, 0), None,
                                         {"device_ms": dev_ms, "bytes": read,
                                          "groups": int(groups.size)})
    # the halves that a shard's settle writes: every 32-byte half of a group
    # whose column's join some row of the shard does not hold
    before = clone(shard)
    ms = timed_once(lambda: pk.settle_columns(shard, ids.clone(), sums, 1, True))[1]
    changed = None
    for x, y in zip(before, shard):
        d = (x != y).view(b, -1, 8).any(0)
        changed = d if changed is None else changed | d
    wrote = int(changed.sum()) * b * 32 * nf
    dev_ms = device_once(lambda: pk.settle_columns(shard, ids.clone(), sums, 1, True))[1]
    plain = timed_once(lambda: pk.settle_columns_torch(shard, ids.clone(), sums, True))[1]
    times[tag("settle_columns", nf)] = (ms, plain, bound(wrote, 0), None,
                                       {"device_ms": dev_ms, "bytes": wrote,
                                        "groups": int(groups.size)})
    log(f"  column_summaries, settle_columns [{LAYOUT_OF[nf]}] {SHARDS} shards of {b}x{n}, "
        f"scatter ({groups.size} groups): summaries {times[tag('column_summaries', nf)][0]:.3f} "
        f"ms, device alone {times[tag('column_summaries', nf)][4]['device_ms']:.3f} ms, "
        f"{read / 1e9:.3f} GB read; settle {ms:.3f} ms, device alone {dev_ms:.3f} ms, "
        f"{wrote / 1e9:.3f} GB written; bit-identical to their plain versions and the tables "
        f"and depth to the one-card pass at {len(SHARD_COLUMN_SHAPES)} shapes")
    del table, before, sums
    torch.cuda.empty_cache()


# the bridge deployment: bullet-js's bridge example at 1,024 peers
BRIDGE_SPEC = {"kind": "bridge", "clusters": 204, "cluster_size": 5, "bridge_peers": 4}


def graph_topologies():
    """The graph pass's shapes: (name, neighbour matrix [P, D])."""
    from bullet_tpu_torch.parallel import topology as topo

    rng = np.random.default_rng(41)
    digraph = rng.random((40, 40)) < 0.08
    np.fill_diagonal(digraph, False)
    holes = topo.random_graph(24, 3, seed=2).neighbors.copy()
    holes[rng.random(holes.shape) < 0.3] = -1  # -1 in the middle of rows
    return [("bridge 6x5+2", topo.bridge((5,) * 6, 2).neighbors),
            ("bridge 2x5+1", topo.bridge((5, 5), 1).neighbors),
            ("star 17", topo.star(17).neighbors), ("star 2000", topo.star(2000).neighbors),
            ("random 64", topo.random_graph(64, 3, seed=5).neighbors),
            ("digraph 40", topo.from_adjacency(digraph).neighbors), ("holes 24", holes),
            ("bridge 204x5+4", topo.bridge((5,) * 204, 4).neighbors)]


def graph_pass_sectors(before, after, dirty, p: int, nf: int) -> int:
    """The graph pass's floor in 32-byte sectors, which is what it moves: it
    reads every row's sector (8 columns) that holds a dirty column and
    writes back every sector that holds a changed entry."""
    from bullet_tpu_torch.ops.packed import GRAPH_GROUP

    n = before[0].shape[1]
    changed = None
    for a, b in zip(before, after):
        d = a != b
        changed = d if changed is None else changed | d
    sectors = int(changed.view(p, -1, GRAPH_GROUP).any(2).sum())
    dirty_sectors = n // 8 if dirty is None else int(dirty.reshape(-1, 8).any(1).sum())
    return 32 * nf * (dirty_sectors * p + sectors)


def check_converge_graph(dev, main_shape, errs, times, nf):
    """The graph pass against its plain version: tables, the rounds' depth
    and every round's count, on small graphs and the 1,024-peer bridge.
    The tables hold no entry below the all-zero one, as a sim's do: the
    pass skips a missing neighbour, where the whole-table loop merges the
    all-zero entry."""
    from bullet_tpu_torch.ops import packed as pk

    def in_domain(table):
        """The table with its absent (cls 0) entries all zero."""
        if nf == 3:
            absent = (table.cv >> pk.CV_SHIFT) == 0
            for f in table:
                f.masked_fill_(absent, 0)
        return table

    def family(seed, p, n):
        return in_domain(random_family(nf, seed, p, n, dev))

    def settled(nb, p, n, seed):
        """A random table at its fixed point over ``nb`` (the plain pass
        over every column)."""
        table = family(seed, p, n)
        plan = pk.GraphPlan(nb)
        pk.converge_graph_packed(table, plan, pk.graph_work(None, n), 4 * p)
        return table, plan

    def pair(table, plan, dirty, cap, what):
        n = table[0].shape[1]
        twin = clone(table)
        work = pk.graph_work(dirty, n)
        _, out = pk.converge_graph_packed(table, plan, work, cap)
        cols = [torch.from_numpy(w).to(dev) for w in work]
        want, plain = timed_once(lambda: pk.converge_graph_packed_torch(
            twin, plan, *cols, max(1, min(cap, plan.neighbors.shape[0] + 1))))
        _pair("converge_graph", errs, (*table, out.cpu()), (*twin, want), f"nf={nf} {what}")
        return out.cpu(), plain

    rng = np.random.default_rng(40 + nf)
    n = 256
    for name, nb in graph_topologies():
        p = nb.shape[0]
        if not pk.graph_pass_fits(p, nf):
            continue
        for cap in (1, 2, 3, 4 * p):
            table = family(800 + p, p, n)
            pair(table, pk.GraphPlan(nb), None, cap, f"{name} all cap={cap}")
            table, plan = settled(nb, p, n, 800 + p)
            dirty = column_seed(rng, n, "sparse")
            src = family(900 + p, p, n)
            cols = np.flatnonzero(dirty)
            r = torch.from_numpy(rng.integers(0, p, cols.size)).to(dev)
            c = torch.from_numpy(cols).to(dev)
            for f, v in zip(table, src):
                f[r, c] = v[r, c]
            pair(table, plan, dirty, cap, f"{name} sparse cap={cap}")
    p, n = main_shape
    nb = graph_topologies()[-1][1]
    plan = pk.GraphPlan(nb)
    dirty = column_seed(rng, n, "scatter")
    # the bridge is strongly connected: its fixed point is every column's
    # join in every row, as the reconcile leaves it
    out, plain = pair(in_domain(dirtied(nf, 41, p, n, dirty, True, dev, win=True)), plan, dirty,
                      4 * p, f"{p}x{n} scatter")
    before = in_domain(dirtied(nf, 41, p, n, dirty, True, dev, win=True))
    after = clone(before)
    work = pk.graph_work(dirty, n)
    _, ms = timed_once(lambda: pk.converge_graph_packed(after, plan, work, 4 * p))
    moved = graph_pass_sectors(before, after, dirty, p, nf)
    del after
    _, dev_ms = device_once(lambda: pk.converge_graph_packed(before, plan, work, 4 * p))
    del before
    torch.cuda.empty_cache()
    rounds = int(out[0]) + 1
    times[tag("converge_graph", nf)] = (
        ms, plain, bound(moved, 0), None,
        {"device_ms": dev_ms, "bytes": moved, "columns": int(dirty.sum()),
         "groups": int(work[0].size), "rounds": rounds})
    log(f"  converge_graph [{LAYOUT_OF[nf]}] {p}x{n}, bridge 204x5+4 ({plan.edges} edges, "
        f"{len(plan.sched)} slot groups): scatter ({int(dirty.sum())} columns, "
        f"{work[0].size} groups, {rounds} rounds, counts {out[1:rounds + 1].tolist()}): kernel "
        f"{ms:.3f} ms, device alone {dev_ms:.3f} ms, plain {plain:.3f} ms, "
        f"{moved / 1e9:.3f} GB moved, its sector floor, bound {bound(moved, 0)[0]:.3f} ms; "
        f"bit-identical to its plain version there and on {len(graph_topologies())} graphs, "
        f"seeds all and sparse, caps 1, 2, 3 and none")


def window_bound(nf: int, entries: int, m: int):
    """Bound of an m-round window join: one read and one write of the
    table; the compares of its O(log m) 3-way joins and the final round."""
    from bullet_tpu_torch.ops.packed import _window_chain

    joins = 2 * len(_window_chain(m - 1)) + 2
    return bound(8 * nf * entries, joins * (2 * nf + 1) * entries)


def check_window(dev, main_shape, errs, times, nf):
    """window_packed against its plain version: every depth of the list on
    small, ragged and big-P shapes, ring and chain; rank1 at P = 8192
    (where the TPU took its halo window, #17); a table past one launch's
    rows (its row tiles and passes); the main shape at the main paths'
    depths, timed at m = 120 and 480."""
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
    # a table taller than one launch takes: row tiles, and two passes at
    # the deepest m
    rows = pk.window_rows(nf, dev)
    p, n = rows + 64, 256
    base = random_family(nf, 73, p, n, dev)
    for wrap, m in ((True, 120), (False, 13), (True, rows // 4 + 5)):
        pair(base, wrap, m, f"{p}x{n} (past the {rows}-row launch) wrap={wrap} m={m}")
    del base
    p, n = main_shape
    base = random_family(nf, 72, p, n, dev)
    pair(base, False, 13, f"{p}x{n} chain m=13")
    plain = {}
    # the main path's depths: phase 6's fast_forward(480) and its jump to
    # the fixed point (1024), phase 5's blind twin jump (513)
    for m in MAIN_WINDOW_DEPTHS:
        plain[m] = pair(base, True, m, f"{p}x{n} ring m={m}")
    report = []
    for m in (120, 480):
        ms = time_ms(lambda: pk.ring_window_packed(base, True, m), 3)
        row = (ms, plain[m], window_bound(nf, p * n, m))
        times[tag("window_packed" if m == 120 else f"window_packed m={m}", nf)] = row
        report.append(f"m={m} ({len(pk._window_chain(m - 1))} doubling steps + the last "
                      f"round): kernel {ms:.3f} ms, plain {plain[m]:.3f} ms, bound "
                      f"{row[2][0]:.3f} ms")
    del base
    log(f"  window_packed [{LAYOUT_OF[nf]}] {p}x{n} ring " + "; ".join(report)
        + f" per call; bit-identical at m in {MAIN_WINDOW_DEPTHS} there, with m in "
        "(1, 13, 120, 2P+3) at small, ragged and P = 4096 shapes and past one launch's "
        f"{rows} rows")


def check_window_shard(dev, shard_shape, errs, times, nf):
    """The window kernel's extended form (the spmd fast_forward's per-shard
    join) against ring_window_shard_torch: shards of 1 to 17 rows at every
    m <= b, 130 columns (a ragged last block), random, zeroed and mixed
    slabs; one shard of phase 9's mesh (256 x 2^20 by default) at its
    passes (m = 256 and 224), random and zeroed slabs, timed at the first; and
    a shard whose extended column is taller than one launch takes (its row
    tiles). Rows and counts exact."""
    from bullet_tpu_torch.ops import packed as pk

    rng = np.random.default_rng(41 + nf)

    def slabs(m, n, kind):
        if kind == "zero":
            return [torch.zeros((m, n), dtype=torch.int32, device=dev) for _ in range(nf)]
        rows = list(random_family(nf, int(rng.integers(1 << 30)), m, n, dev))
        if kind == "mixed":  # every other row zeroed
            for f in rows:
                f[1::2] = 0
        return rows

    def pair(base, m, kinds, what):
        n = base[0].shape[1]
        tops, bottoms = slabs(m, n, kinds[0]), slabs(m, n, kinds[1])
        got = clone(base)
        c_got = pk.ring_window_shard_packed(got, [t.clone() for t in tops],
                                            [t.clone() for t in bottoms], m)
        (want, c_want), ms = timed_once(lambda: pk.ring_window_shard_torch(
            list(base), tops, bottoms, m))
        _pair("window_shard", errs, (*got, c_got), (*want, c_want), f"nf={nf} {what}")
        return ms

    kinds = (("random", "random"), ("zero", "zero"), ("random", "zero"), ("mixed", "random"))
    for b in (1, 3, 8, 17):
        base = random_family(nf, 900 + b, b, 130, dev)
        for m in range(1, b + 1):
            for kind in kinds:
                pair(base, m, kind, f"{b}x130 m={m} slabs={kind}")
    rows = pk.window_rows(nf, dev)
    b, m = rows + 64, 32
    base = random_family(nf, 950, b, 256, dev)
    for kind in kinds[:3]:
        pair(base, m, kind, f"{b}x256 m={m} (past the {rows}-row launch) slabs={kind}")
    del base
    b, n = shard_shape
    passes = spmd_passes(b * SHARDS, b)
    base = random_family(nf, 960, b, n, dev)
    plain = {}
    for m in passes:
        for kind in kinds[:2]:
            plain[m] = pair(base, m, kind, f"{b}x{n} m={m} slabs={kind}")
    m = passes[0]
    tops, bottoms = slabs(m, n, "random"), slabs(m, n, "random")
    ms = time_ms(lambda: pk.ring_window_shard_packed(base, tops, bottoms, m), 3)
    joins = 2 * len(pk._window_chain(m - 1)) + 2
    times[tag("window_shard", nf)] = (ms, plain[m], shard_bound(nf, b, m, n, joins))
    del base, tops, bottoms
    log(f"  window_shard [{LAYOUT_OF[nf]}] {b}x{n} per shard, m={m}: kernel {ms:.3f} ms, "
        f"plain {plain[m]:.3f} ms, bound {times[tag('window_shard', nf)][2][0]:.3f} ms per "
        f"call; bit-identical at m in {passes} (random and zeroed slabs), on shards of "
        f"1 to 17 rows and on {rows + 64} rows, past one launch's {rows}")


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


# ------------------------------------------------ phase 3, lean and shards


def lean_table(seed: int, p: int, n: int, device):
    """A dense table for the lean kernels: its four value keys tiled as
    ``random_table``'s, and writer/ctr/tick as 1 x 1 placeholders, which no
    lean kernel reads or writes (so a 1024 x 2^20 table takes 17.2 GB)."""
    from bullet_tpu_torch.ops.merge import TableState

    rng = np.random.default_rng(seed)
    w = min(n, BASE_N)
    blocks = [rng.integers(lo, hi, (p, w), dtype=np.int32)
              for lo, hi in ((0, 4), (-3, 3), (-3, 3), (0, 4))]
    rest = [torch.zeros((1, 1), dtype=torch.int32, device=device) for _ in range(3)]
    return TableState(*tiled(blocks, n, device), *rest)


def check_ring_lean(dev, lean_shape, errs, times):
    """The lean round against its plain version, ring and chain: writer,
    ctr and tick untouched at the small and ragged shapes (full tables
    there), the value keys at the main lean shape, timed."""
    from bullet_tpu_torch.ops.ring_kernel import ring_round_lean, ring_round_lean_torch

    for p in (1, 2, 3, 1000, 1024):
        n = 333 if p >= 1000 else 130
        base = random_table(110 + p, p, n, dev)
        for wrap in (True, False):
            got, c_got = ring_round_lean(clone(base), wrap)
            want, c_want = ring_round_lean_torch(clone(base), wrap)
            _pair("ring_round_lean", errs, (*got, c_got), (*want, c_want), f"p={p} wrap={wrap}")
            _pair("ring_round_lean", errs, got[4:], base[4:], f"p={p} metadata untouched")
    p, n = lean_shape
    table, twin = lean_table(12, p, n, dev), lean_table(12, p, n, dev)
    plain = {}
    for what, wrap in (("chain", False), ("ring", True)):
        c_got = ring_round_lean(table, wrap)[1]
        (_, c_want), plain[what] = timed_once(lambda: ring_round_lean_torch(twin, wrap))
        _pair("ring_round_lean", errs, (*table[:4], c_got), (*twin[:4], c_want),
              f"{p}x{n} {what}")
    del twin
    ms = time_ms(lambda: ring_round_lean(table, True), 5)
    del table
    times["ring_round_lean"] = (ms, plain["ring"], round_bound(4, p * n))
    log(f"  ring_round_lean {p}x{n}: kernel {ms:.3f} ms, plain {plain['ring']:.3f} ms per "
        "round; ring and chain bit-identical, metadata untouched")


def check_frontier_lean(dev, lean_shape, errs, times):
    """The dense frontier at nf = 4 (lean) against its plain version: m = 1
    and 8, all and sparse stripes, ring and chain; the main lean shape
    timed at m = 8 over all stripes."""
    from bullet_tpu_torch.ops.ring_kernel import (
        frontier_round_dense,
        frontier_round_dense_torch,
        frontier_tile_n,
    )

    def pair(table, twin, ids, tile, wrap, m, what):
        t_total = table.cls.shape[1] // tile
        _, ids_got = frontier_round_dense(table, ids, tile, wrap, "reference", m, lean=True)
        (_, ids_want), ms = timed_once(lambda: frontier_round_dense_torch(
            twin, ids, tile, wrap, "reference", m, lean=True))
        count = int(ids_want[t_total])
        _pair("frontier_round_dense", errs, (*table, ids_got[:count], ids_got[t_total:]),
              (*twin, ids_want[:count], ids_want[t_total:]), f"lean {what}")
        return ms

    rng = np.random.default_rng(13)
    for p in FRONTIER_PS:
        n = FRONTIER_WIDTH[p]
        tile = frontier_tile_n(n)
        t_total = n // tile
        base = random_table(210 + p, p, n, dev)
        cases = [(base, m, dirty) for m in (1, 8)
                 for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4)]
        if p >= 17:
            cases.append((settling(base, tile, 4), 8, np.ones(t_total, bool)))
        for (table, m, dirty), wrap in itertools.product(cases, (True, False)):
            pair(clone(table), clone(table), _ids(dirty, m, dev), tile, wrap, m,
                 f"{p}x{n} m={m} wrap={wrap}")
    p, n = lean_shape
    tile = frontier_tile_n(n)
    t_total = n // tile
    table, twin = lean_table(14, p, n, dev), lean_table(14, p, n, dev)
    full = _ids(np.ones(t_total, bool), 8, dev)
    plain = pair(table, twin, full, tile, True, 8, f"{p}x{n} m=8 all")
    pair(table, twin, _ids(rng.random(t_total) < 0.1, 8, dev), tile, False, 8,
         f"{p}x{n} m=8 sparse chain")
    pair(table, twin, _ids(np.ones(t_total, bool), 1, dev), tile, True, 1, f"{p}x{n} m=1 all")
    del twin
    ms = time_ms(lambda: frontier_round_dense(table, full, tile, True, "reference", 8, True), 3)
    del table
    # one read and one write of the four keys whatever m (see packed_round fused)
    times["frontier_round_dense lean"] = (ms, plain, round_bound(4, p * n, rounds=8))
    log(f"  frontier_round_dense [lean] {p}x{n} tile {tile}, m=8, all {t_total} stripes: "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms per call; m=1 and 8 bit-identical")


def check_merge_lean(dev, lean_shape, errs, times):
    """The lean merge (merge.cu at nf = 4, in place into its first operand)
    against its plain version: metadata untouched at the small shapes, the
    value keys at the lean main path's shape (its reconcile's), timed."""
    from bullet_tpu_torch.ops.merge import lean_fields, merge_lean, merge_lean_torch

    def pair(got, want, b, what):
        c_got = merge_lean(lean_fields(got), lean_fields(b))
        (c_want, plain) = timed_once(lambda: merge_lean_torch(lean_fields(want), lean_fields(b)))
        _pair("merge", errs, (*got[:4], c_got), (*want[:4], c_want), f"lean {what}")
        return plain

    shapes = ((1, 1), (3, 130), (64, 1000))
    for p, n in shapes:
        a, b = random_table(31 + p, p, n, dev), random_table(37 + n, p, n, dev)
        got = clone(a)
        pair(got, clone(a), b, f"{p}x{n}")
        _pair("merge", errs, got[4:], a[4:], f"lean {p}x{n} metadata untouched")
    p, n = lean_shape
    # three lean tables of 17.2 GB at 1024 x 2^20 (a copy of a would be a fourth)
    got, want, b = lean_table(31, p, n, dev), lean_table(31, p, n, dev), lean_table(37, p, n, dev)
    plain = pair(got, want, b, f"{p}x{n}")
    del want
    ms = time_ms(lambda: merge_lean(lean_fields(got), lean_fields(b)), 5)
    del got, b
    times["merge lean"] = (ms, plain, bound(48 * p * n, 11 * p * n))
    log(f"  merge [lean, in place] {p}x{n}: kernel {ms:.3f} ms, plain {plain:.3f} ms per call; "
        f"bit-identical at {len(shapes) + 1} shapes")


def _boundary(rng, s, n, dev, zero: bool):
    """[s, n] boundary rows of the seven dense fields: random with ties, or
    zeros (a chain's end)."""
    if zero:
        return [torch.zeros((s, n), dtype=torch.int32, device=dev) for _ in range(7)]
    ranges = ((0, 4), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 4), (0, 5))
    return [torch.from_numpy(rng.integers(lo, hi, (s, n), dtype=np.int32)).to(dev)
            for lo, hi in ranges]


def check_frontier_shard(dev, shard_shape, errs, times):
    """The per-shard frontier against its plain version: reference, lww and
    lean (nf = 4); m = 1 (the sweep), m = 8 (the pipelined pass) and
    m = 3 (the m-sweep loop), each with s = m boundary rows and with
    s = 11; random boundary rows (a ring, or a chain's inner shard) and
    zeroed ones (a chain's end shard) on either side; all and sparse
    stripes; shards of 1 and 3 rows (fewer than m: the pass has no
    test-free body), 17 and more up to the main path's. Counts
    [m, t_total] and rows exact, and at m = 1 and 8 the boundary rows as
    they were; the shard shape timed for nf = 7 and 4."""
    from bullet_tpu_torch.ops.ring_kernel import (
        beats_of,
        frontier_shard_round,
        frontier_shard_round_torch,
        frontier_tile_n,
    )

    rng = np.random.default_rng(17)

    def pair(base, m, s, mode, lean, zero_top, zero_bottom, dirty, what):
        b, n = base.cls.shape
        tile = frontier_tile_n(n)
        nf = 4 if lean else 7
        tops = _boundary(rng, s, n, dev, zero_top)[:nf]
        bottoms = _boundary(rng, s, n, dev, zero_bottom)[:nf]
        got, want = clone(base), clone(base)
        ids = _ids(dirty, m, dev)
        copies = [t.clone() for t in tops], [t.clone() for t in bottoms]
        c_got = frontier_shard_round(got[:nf], *copies, ids, tile, mode, m)
        c_want, ms = timed_once(lambda: frontier_shard_round_torch(
            want[:nf], tops, bottoms, ids, tile, beats_of(nf, mode), m))
        name = "frontier_shard" if m == 1 else "frontier_shard fused"
        _pair(name, errs, (*got, c_got), (*want, c_want), what)
        if m in (1, 8):  # the boundary rows are read only
            _pair(name, errs, (*copies[0], *copies[1]), (*tops, *bottoms), f"{what} boundary")
        return ms

    for b, n in ((1, 64), (3, 512), (8, 64), (8, 1024), (17, 1024), (37, 512), (256, 4096)):
        base = random_table(400 + b, b, n, dev)
        t_total = n // frontier_tile_n(n)
        for m, s in ((1, 1), (1, 11), (8, 8), (8, 11), (3, 3), (3, 11)):
            for mode, lean in (("reference", False), ("lww", False), ("reference", True)):
                for zero_top, zero_bottom in ((False, False), (True, False), (False, True)):
                    for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4):
                        pair(base, m, s, mode, lean, zero_top, zero_bottom, dirty,
                             f"{b}x{n} m={m} s={s} {mode} lean={lean} "
                             f"zero={zero_top},{zero_bottom}")
    b, n = shard_shape
    t_total = n // frontier_tile_n(n)
    base = random_table(41, b, n, dev)
    plain = {}
    for m in (1, 8):
        for mode, lean in (("reference", False), ("lww", False), ("reference", True)):
            ms = pair(base, m, m, mode, lean, False, mode == "lww", np.ones(t_total, bool),
                      f"{b}x{n} m={m} {mode} lean={lean}")
            plain.setdefault((m, lean), ms)
    tops = _boundary(rng, 8, n, dev, False)
    bottoms = _boundary(rng, 8, n, dev, False)
    for m, lean, name in ((1, False, "frontier_shard"), (8, False, "frontier_shard fused"),
                          (8, True, "frontier_shard fused lean")):
        nf = 4 if lean else 7
        ids = _ids(np.ones(t_total, bool), m, dev)
        ms = time_ms(lambda: frontier_shard_round(base[:nf], [t[:m] for t in tops[:nf]],
                                                  [t[:m] for t in bottoms[:nf]], ids,
                                                  frontier_tile_n(n), "reference", m), 3)
        # whatever m: one read and one write of the shard's rows and one
        # read of the 2 m boundary rows; m rounds of two joins (the key
        # compares and the selects) over the extended column
        ops = m * (38 if nf == 7 else 18) * (b + 2 * m) * n
        times[name] = (ms, plain[m, lean], bound(8 * nf * (b + m) * n, ops))
        log(f"  {name} {b}x{n} per shard, m={m}, nf={nf}, all {t_total} stripes: kernel "
            f"{ms:.3f} ms, plain {plain[m, lean]:.3f} ms per call, bound "
            f"{times[name][2][0]:.3f} ms; bit-identical (reference, lww, lean; random and "
            "zeroed boundary rows)")
    del base


# PyTorch operators that launch a kernel of their own (views and empty
# allocations launch none)
LAUNCHING_OPS = ("zeros", "zero_", "fill_", "add", "add_", "maximum", "copy_", "_to_copy",
                 "index_put_", "cat", "nonzero")


class OpCount(TorchDispatchMode):
    """Counts of the PyTorch operators run inside ``with OpCount() as ops:``,
    by name; the port's own kernels are counted apart, by
    ``_build.LAUNCHES``."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))

    def launching(self) -> dict:
        return {k: v for k, v in sorted(self.counts.items()) if k in LAUNCHING_OPS}


def fold_yardsticks(fold, rows, combine):
    """Times of one fold of the shards' ``rows`` into an ids array: its
    device time alone (``device_once``); and, host-inclusive like every
    row's ms (20 back-to-back calls), the host's fold that it replaces,
    ``combine`` (one zeroed tensor, S adds, the window S maximums too, on
    the operators PyTorch launches) then the compaction of the one
    combined row; with the launches each makes (port kernels and PyTorch
    operators, counted)."""
    from bullet_tpu_torch import _build

    def launches(fn):
        before = sum(_build.LAUNCHES.values())
        with OpCount() as ops:
            fn()
        return sum(_build.LAUNCHES.values()) - before, ops.launching()

    fresh, counted = rows.clone(), rows.clone()
    _, device_ms = device_once(lambda: fold(fresh))
    host = lambda: fold(combine(rows)[None])  # noqa: E731
    host_ms = time_ms(host, 20)
    return device_ms, host_ms, {"one launch": launches(lambda: fold(counted)),
                                "host fold": launches(host)}


def check_compact_counts(dev, t_main: int, errs, times, floor: float):
    """The count fold and compaction against its plain version on the
    [S, m, t_total] counts of S = 1 and SHARDS shards, random, all-zero and
    all-dirty (negative counts included: sums wrap like int32), t_total in
    {1, 7, 8192} and the main path's, m = 1 and 8; cells past the count are
    unspecified, and both leave the counts zeroed. At S = SHARDS and the
    main path's t_total: its time on both clocks beside the launch floor
    and the host's fold it replaces."""
    from bullet_tpu_torch.ops.packed import compact_counts, compact_counts_torch

    rng = np.random.default_rng(19)

    def pair(counts, what):
        _, m, t_total = counts.shape
        rows, twin = counts.clone(), counts.clone()
        got = compact_counts(rows)
        want, ms = timed_once(lambda: compact_counts_torch(twin))
        count = int(want[t_total])
        name = "compact_counts" if m == 1 else "compact_counts fused"
        _pair(name, errs, (got[:count], got[t_total:], rows), (want[:count], want[t_total:], twin),
              what)
        if bool(rows.any()):
            raise AssertionError(f"{name} {what}: the fold left counts unzeroed")
        return ms

    plain = {}
    for t_total in (1, 7, 8192, t_main):
        for m in (1, 8):
            for shards in (1, SHARDS):
                size = (shards, m, t_total)
                for what, counts in (
                    ("random", rng.integers(-2, 4, size) * (rng.random(size) < 0.3)),
                    ("zero", np.zeros(size)),
                    ("dirty", rng.integers(1, 1 << 30, size)),
                ):
                    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
                    ms = pair(c, f"t_total={t_total} m={m} S={shards} {what}")
                    if t_total == t_main and shards == SHARDS and what == "random":
                        plain[m] = ms
    out = torch.empty(t_main + 3, dtype=torch.int32, device=dev)

    def summed(rows):
        total = torch.zeros(rows.shape[1:], dtype=torch.int32, device=dev)
        for row in rows:
            total = total + row
        return total

    for m, name in ((1, "compact_counts"), (8, "compact_counts fused")):
        rows = torch.from_numpy(rng.integers(0, 3, (SHARDS, m, t_main)).astype(np.int32)).to(dev)
        fold = lambda c: compact_counts(c, out)  # noqa: E731
        device_ms, host_ms, counted = fold_yardsticks(fold, rows, summed)
        ms = time_ms(lambda: fold(rows), 20)
        times[name] = (ms, plain[m], bound(8 * SHARDS * m * t_main + 4 * (t_main + 3),
                                           (SHARDS + 1) * m * t_main), None,
                       {"device_ms": device_ms, "launch_floor_ms": floor,
                        "host_fold_ms": host_ms})
        log(f"  {name} S={SHARDS}, t_total={t_main}, m={m}: kernel {ms:.4f} ms (host-inclusive), "
            f"{device_ms:.4f} ms (device alone; the launch floor {floor:.4f} ms), plain "
            f"{plain[m]:.4f} ms per call; the host's fold it replaces {host_ms:.4f} ms; "
            f"launches per fold (port kernels, PyTorch operators): one launch "
            f"{counted['one launch']}, host fold {counted['host fold']}; bit-identical, "
            "counts zeroed")


def check_small_lean_and_sharded_sims(dev):
    """Lean sims and sharded sims (4 shards on the card against 4 virtual
    shards on the CPU) at a small size: the card against the CPU, every
    field, residuals, rounds and reads."""
    from bullet_tpu_torch import PeerNetworkSim
    from bullet_tpu_torch.convert import table_to_numpy

    cases = [dict(lean_gossip=True)]
    cases += [dict(mesh_devices=4, use_shard_map=True, mode=m, lean_gossip=lean)
              for m, lean in (("lww", False), ("reference", True))]
    cases.append(dict(mesh_devices=4, mode="lww"))
    for kw, topology in itertools.product(cases, ("ring", "chain")):
        sims = []
        for d in (dev, "cpu"):
            extra = dict(kw)
            if "mesh_devices" in extra:
                extra["mesh_devices"] = [d] * extra["mesh_devices"]
            sims.append(PeerNetworkSim(64, capacity=4096, topology=topology, device=d,
                                       use_kernels=True, **extra))
        rng = np.random.default_rng(8)
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
            r3 = sim.run_until_converged(max_rounds=11)
            sim.put(33, "s/later", 5)
            sim.reconcile()
            results.append((r1, r2, r3, sim.last_residual, sim.converged(), sim.tables_equal(),
                            sim.get(5, "s")))
        a, b = (table_to_numpy(s.table) for s in sims)
        e = max(int(np.abs(x.astype(np.int64) - y).max()) for x, y in zip(a, b))
        if results[0] != results[1] or e:
            raise AssertionError(f"small sim {kw} {topology}: {results}, max_abs_err {e}")
    log("  small lean and sharded sims (64 x 4096, 4 shards on the card; ring/chain, "
        "lean/lww, spmd and data mesh): card == CPU")


# ------------------------------------------- phase 3, the packed mesh kernels


def shard_bound(nf: int, b: int, s: int, n: int, joins: int):
    """Bound of a per-shard step on a shard of b x n with s boundary rows
    each way: one read and one write of the shard's rows and one read of
    the 2 s boundary rows, nf x 4 bytes an entry; ``joins`` merges of
    (nf + 1) compares and nf selects over the extended column."""
    return bound(4 * nf * (2 * b + 2 * s) * n, joins * (2 * nf + 1) * (b + 2 * s) * n)


def window_joins(m: int) -> int:
    """Joins of the reference's distance chain to radius m: two per
    doubling step s = min(m - r, r + 1) (the least work that computes the
    window step, and the kernel's)."""
    r = steps = 0
    while r < m:
        r += min(m - r, r + 1)
        steps += 1
    return 2 * steps


def check_frontier_shard_packed(dev, shard_shape, errs, times, nf):
    """The packed family's per-shard kernels against their plain versions:
    #22 (m = 1, the sweep), #23 (m = 8, the pipelined pass) and the m-sweep
    loop (m = 3), each with s = m boundary rows and with s = 11, #25 (the
    window, m = 3, 15 and 63 on m-row slabs), on random boundary rows (a
    ring, or a chain's inner shard) and zeroed ones (a chain's end shard),
    all and sparse stripes, shards of 1, 3 and 17 rows (the frontier
    only), small and ragged shards, a stripe split over blocks of the
    window (16 columns each) and a shard of 1024 rows, more than the
    window kernel's shared-memory tile holds at nf = 3 (its row tiles and
    their carried halos); then one shard of the phase 9 mesh (256 x 2^20 by
    default), timed. Rows, counts and stats exact, and the frontier's
    boundary rows as they were at m = 1 and 8."""
    from bullet_tpu_torch.ops import packed as pk
    from bullet_tpu_torch.ops.ring_kernel import frontier_tile_n, frontier_shard_round_torch

    rng = np.random.default_rng(23 + nf)

    def slabs(s, n, zero):
        if zero:
            return [torch.zeros((s, n), dtype=torch.int32, device=dev) for _ in range(nf)]
        return list(random_family(nf, int(rng.integers(1 << 30)), s, n, dev))

    def pair(base, m, s, window, zero_top, zero_bottom, dirty, what):
        n = base[0].shape[1]
        tile = frontier_tile_n(n)
        tops, bottoms = slabs(s, n, zero_top), slabs(s, n, zero_bottom)
        got, want = clone(base), clone(base)
        ids = _ids(dirty, m, dev)
        copies = ([t.clone() for t in tops], [t.clone() for t in bottoms])
        if window:
            name = "frontier_shard_window"
            c_got = pk.frontier_shard_window(got, *copies, ids, tile, m)
            c_want, ms = timed_once(lambda: pk.frontier_shard_window_torch(
                want, tops, bottoms, ids, tile, m))
        else:
            name = "frontier_shard packed" if m == 1 else "frontier_shard packed fused"
            c_got = pk.frontier_shard_round_packed(got, *copies, ids, tile, m)
            c_want, ms = timed_once(lambda: frontier_shard_round_torch(
                want, tops, bottoms, ids, tile, pk.packed_beats, m))
        _pair(name, errs, (*got, c_got), (*want, c_want), f"nf={nf} {what}")
        if not window and m in (1, 8):  # the boundary rows are read only
            _pair(name, errs, (*copies[0], *copies[1]), (*tops, *bottoms),
                  f"nf={nf} {what} boundary")
        return ms

    frontier = ((1, 1), (1, 11), (8, 8), (8, 11), (3, 3), (3, 11))
    for b, n in ((1, 64), (3, 512), (8, 64), (8, 1024), (17, 1024), (37, 512), (256, 4096),
                 (1024, 4096)):
        base = random_family(nf, 800 + b, b, n, dev)
        t_total = n // frontier_tile_n(n)
        cases = [(m, s, False) for m, s in frontier]
        if b >= 8:
            cases += [(m, m, True) for m in (3, 15, 63)]
        for m, s, window in cases:
            for zero_top, zero_bottom in ((False, False), (True, False), (False, True)):
                for dirty in (np.ones(t_total, bool), rng.random(t_total) < 0.4):
                    pair(base, m, s, window, zero_top, zero_bottom, dirty,
                         f"{b}x{n} m={m} s={s} window={window} zero={zero_top},{zero_bottom}")
        del base
    b, n = shard_shape
    tile = frontier_tile_n(n)
    t_total = n // tile
    base = random_family(nf, 83, b, n, dev)
    every = np.ones(t_total, bool)
    plain = {}
    for m, window in ((1, False), (8, False), (63, True)):
        plain[m] = pair(base, m, m, window, False, m == 8, every, f"{b}x{n} m={m}")
    tops, bottoms = slabs(63, n, False), slabs(63, n, False)
    for m, name, window in ((1, "frontier_shard packed", False),
                            (8, "frontier_shard packed fused", False),
                            (63, "frontier_shard_window", True)):
        ids = _ids(every, m, dev)
        top, bottom = [t[-m:].contiguous() for t in tops], [t[:m].contiguous() for t in bottoms]
        if window:
            ms = time_ms(lambda: pk.frontier_shard_window(base, top, bottom, ids, tile, m), 2)
            joins = window_joins(m)
        else:
            ms = time_ms(lambda: pk.frontier_shard_round_packed(base, top, bottom, ids, tile, m), 3)
            joins = 2 * m
        times[tag(name, nf)] = (ms, plain[m], shard_bound(nf, b, m, n, joins))
        log(f"  {name} [{LAYOUT_OF[nf]}] {b}x{n} per shard, m={m}, all {t_total} stripes: "
            f"kernel {ms:.3f} ms, plain {plain[m]:.3f} ms per call, bound "
            f"{times[tag(name, nf)][2][0]:.3f} ms; bit-identical (random and zeroed boundary "
            "rows, all and sparse stripes, small and ragged shards)")
    del base, tops, bottoms


def check_compact_counts_window(dev, t_main: int, errs, times, floor: float):
    """The window fold against its plain version on the [S, 2, t_total]
    stats of S = 1 and SHARDS shards, random, all-zero and all-at-m (row 0
    sums wrap like int32), t_total in {1, 7, 8192} and the main path's,
    m = 15 and 63; cells past the count are unspecified, and both leave
    the stats zeroed. At S = SHARDS and the main path's t_total: its time
    on both clocks beside the launch floor and the host's fold it
    replaces."""
    from bullet_tpu_torch.ops.packed import compact_counts_window, compact_counts_window_torch

    rng = np.random.default_rng(29)
    plain = None
    for t_total in (1, 7, 8192, t_main):
        for m in (15, 63):
            for shards in (1, SHARDS):
                size = (shards, t_total)
                for what, rows in (
                    ("random", (rng.integers(-5, 1 << 20, size), rng.integers(0, m + 1, size))),
                    ("zero", (np.zeros(size), np.zeros(size))),
                    ("at m", (rng.integers(1, 1 << 30, size), np.full(size, m))),
                ):
                    stats = torch.from_numpy(np.stack(rows, 1).astype(np.int32)).to(dev)
                    mine, twin = stats.clone(), stats.clone()
                    got = compact_counts_window(mine, m)
                    want, ms = timed_once(lambda: compact_counts_window_torch(twin, m))
                    k = int(want[t_total])
                    what = f"t_total={t_total} m={m} S={shards} {what}"
                    _pair("compact_counts window", errs, (got[:k], got[t_total:], mine),
                          (want[:k], want[t_total:], twin), what)
                    if bool(mine.any()):
                        raise AssertionError(f"compact_counts window {what}: stats unzeroed")
                    if (t_total == t_main and m == 63 and shards == SHARDS
                            and what.endswith("random")):
                        plain = ms
    stats = torch.from_numpy(np.stack((rng.integers(0, 9, (SHARDS, t_main)),
                                       rng.integers(0, 64, (SHARDS, t_main))), 1)
                             .astype(np.int32)).to(dev)
    out = torch.empty(t_main + 3, dtype=torch.int32, device=dev)

    def agreed(rows):
        total = torch.zeros(rows.shape[1:], dtype=torch.int32, device=dev)
        for row in rows:
            total[0] += row[0]
            total[1] = torch.maximum(total[1], row[1])
        return total

    fold = lambda c: compact_counts_window(c, 63, out)  # noqa: E731
    device_ms, host_ms, counted = fold_yardsticks(fold, stats, agreed)
    ms = time_ms(lambda: fold(stats), 20)
    row = (ms, plain, bound(16 * SHARDS * t_main + 4 * (t_main + 3), (SHARDS + 1) * 2 * t_main),
           None, {"device_ms": device_ms, "launch_floor_ms": floor, "host_fold_ms": host_ms})
    times["compact_counts window"] = times[tag("compact_counts window", 1)] = row
    log(f"  compact_counts window S={SHARDS}, t_total={t_main}, m=63: kernel {ms:.4f} ms "
        f"(host-inclusive), {device_ms:.4f} ms (device alone; the launch floor {floor:.4f} ms), "
        f"plain {plain:.4f} ms per call; the host's fold it replaces {host_ms:.4f} ms; launches "
        f"per fold (port kernels, PyTorch operators): one launch {counted['one launch']}, host "
        f"fold {counted['host fold']}; bound {row[2][0]:.2g} ms; bit-identical, stats zeroed")


def check_small_packed_mesh_sims(dev):
    """Packed, rank and rank1 sims on 4 shards of 16 rows on the card (the
    window route at m = 15) against 4 virtual shards on the CPU (the plain
    single-round route), spmd and data mesh, ring and chain: every field,
    residuals, rounds, fast_forward and reads."""
    from bullet_tpu_torch import PeerNetworkSim
    from bullet_tpu_torch.convert import table_to_numpy

    for layout, spmd, topology in itertools.product(
            ("packed", "rank", "rank1"), (True, False), ("ring", "chain")):
        sims = [PeerNetworkSim(64, capacity=4096, topology=topology, layout=layout, device=d,
                               mesh_devices=[d] * 4, use_shard_map=spmd, use_kernels=True)
                for d in (dev, "cpu")]
        rng = np.random.default_rng(9)
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
            r2 = sim.run_until_converged()
            sim.put(9, "s/late", 4)
            r3 = sim.run_until_converged(max_rounds=20)
            sim.put(33, "s/later", 5)
            sim.reconcile()
            results.append((r1, f1, r2, r3, sim.last_residual, sim.converged(),
                            sim.tables_equal(), sim.get(5, "s"), sim._convergence_strategy()[0]))
        a, b = (table_to_numpy(s.table) for s in sims)
        e = max(int(np.abs(x.astype(np.int64) - y).max()) for x, y in zip(a, b))
        if results[0] != results[1] or e:
            raise AssertionError(f"small {layout} mesh sim spmd={spmd} {topology}: {results}, "
                                 f"max_abs_err {e}")
    log("  small packed, rank and rank1 mesh sims (64 x 4096, 4 shards on the card; ring/chain, "
        "spmd and data mesh, fast_forward included): card == CPU")


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

    def seed():
        """The dirty columns the next converge starts from."""
        cols = sim._marks.columns()
        return f"{n if cols is None else int(cols.sum())}/{n} columns"

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
    seeded = seed()
    with window("packed run_until_converged", secs):
        rounds = sim.run_until_converged()
    route = sim._convergence_strategy()[0]
    conv = secs["packed run_until_converged"]
    log(f"  put_bulk {args.packed_ops} ops + 3 string/object puts: "
        f"{secs['packed put']:.3f} s (host)")
    log(f"  step(1) (reduce + apply {applied} winning ops + 1 ring round): "
        f"{secs['packed step(1)']:.3f} s, residual {residual}")
    log(f"  run_until_converged [{route}]: {rounds} rounds in {conv:.3f} s "
        f"({1000 * conv / max(rounds, 1):.3f} ms/round), seed {seeded} (the column pass)")
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
        sim.step(0)
        seeded = seed()
        inc_rounds = sim.run_until_converged()
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("incremental converge did not reach the fixed point")
    log(f"  put_bulk {len(second[0])} ops + run_until_converged: {inc_rounds} rounds in "
        f"{secs['packed incremental converge']:.3f} s, seed {seeded}")
    # a converge capped at the diameter keeps the fused frontier loop
    # (#19/#20), seeded with the stripes of the dirty columns; an uncapped
    # one then ends a cutoff on the column pass
    capped = batch(max(1, args.packed_ops // 64), n_leaf)
    sim.put_bulk(*capped)
    sim.step(0)
    seeded, stripes = seed(), int(sim._marks.seed(sim.device).sum())
    loops = _build.LAUNCHES["frontier_round_packed"]
    with window("packed capped converge", secs):
        cap_rounds = sim.run_until_converged(max_rounds=p // 2)
        cap_left = sim.last_residual
        sim.run_until_converged()
    if _build.LAUNCHES["frontier_round_packed"] == loops:
        raise AssertionError("the capped converge did not take the frontier loop")
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("the capped converge and its finish did not reach the fixed point")
    log(f"  put_bulk {len(capped[0])} ops + run_until_converged(max_rounds={p // 2}): "
        f"{cap_rounds} rounds, residual {cap_left}, seed {seeded} on {stripes}/{t_total} "
        f"stripes; then to the fixed point: {secs['packed capped converge']:.3f} s for both")
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
    del sim
    torch.cuda.empty_cache()
    fused_rounds(p, n, dev, window, secs)
    launches = {k: _build.LAUNCHES[k] for k in (*PACKED_KERNELS, FUSED_ROUNDS)}
    log(f"  launches on the packed main path: {dict(_build.LAUNCHES)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"packed main path never launched: {missing}")
    return launches


def bench_packed_table(p: int, n: int, dev):
    """The reference's packed bench table (bench.py:100-125, its
    ``build_packed``): entry (row, col) from the hash h = (row * 1103515245
    + col * 40503) & 0x7FFFFFFF, each field a salted remix of h mod a
    range (cls in [0, 4), khi and klo in [-1000, 1000), vid below 2^20),
    int32 products wrapping as in JAX; built on the card 32 rows at a
    time."""
    from bullet_tpu_torch.ops.packed import PackedTable

    fields = [torch.empty((p, n), dtype=torch.int32, device=dev) for _ in range(3)]
    col = torch.arange(n, dtype=torch.int64, device=dev)
    for r0 in range(0, p, 32):
        row = torch.arange(r0, min(p, r0 + 32), dtype=torch.int64, device=dev)[:, None]
        h = (row * 1103515245 + col * 40503) & 0x7FFFFFFF

        def mix(salt, mod):
            return ((h ^ salt) * 1664525 & 0x7FFFFFFF) % mod

        cls = mix(1, 4)
        for f, v in zip(fields, (mix(2, 2000) - 1000, mix(3, 2000) - 1000,
                                 (cls << 28) | mix(4, 1 << 20))):
            f[r0:r0 + row.shape[0]] = v.to(torch.int32)
    return PackedTable(*fields)


# the reference's packed bench cell (bench.py:136-170): 480 rounds, under
# the 1024-ring's diameter of 512, as launches of stripe_fuse(3) = 8
BENCH_ROUNDS, BENCH_FUSE = 480, 8


def fused_rounds(p: int, n: int, dev, window, secs: dict):
    """Phase 5's last window, the reference's packed bench cell
    (bench.py:95-200): BENCH_ROUNDS ring rounds on a fresh bench table as
    launches of ``ring_multiround_packed(m = 8)`` (#11, one pipelined pass
    each), against as many ``ring_round_packed`` on an identical twin;
    tables bit-identical, each launch's count equal to the sum of its 8
    single rounds' (wrapped like int32); logs the windowed logical
    merges/s, 2 P N rounds / s, of both."""
    from bullet_tpu_torch.ops.packed import _wrap_int32, ring_multiround_packed, ring_round_packed

    rounds = min(BENCH_ROUNDS, (p // 2) // BENCH_FUSE * BENCH_FUSE)
    table, twin = bench_packed_table(p, n, dev), bench_packed_table(p, n, dev)
    with window("packed fused rounds", secs):
        fused = [ring_multiround_packed(table, True, BENCH_FUSE)[1]
                 for _ in range(rounds // BENCH_FUSE)]
    with window("packed single rounds", secs):
        single = [ring_round_packed(twin, True)[1] for _ in range(rounds)]
    fused, single = torch.stack(fused).tolist(), torch.stack(single).tolist()
    per_launch = [_wrap_int32(sum(single[i:i + BENCH_FUSE]))
                  for i in range(0, rounds, BENCH_FUSE)]
    if fused != per_launch or not all(torch.equal(a, b) for a, b in zip(table, twin)):
        raise AssertionError("packed fused rounds differ from single rounds")
    del table, twin
    torch.cuda.empty_cache()
    t_fused, t_single = secs["packed fused rounds"], secs["packed single rounds"]
    log(f"  fused rounds (bench.py's packed cell: {rounds} ring rounds on its hash table, "
        f"{p}x{n}): {rounds // BENCH_FUSE} launches of m={BENCH_FUSE} in {t_fused:.4f} s, "
        f"{2 * p * n * rounds / t_fused:.6g} logical merges/s (2 x {p} x {n} x {rounds} / s); "
        f"{rounds} single rounds on a twin in {t_single:.4f} s, "
        f"{2 * p * n * rounds / t_single:.6g} merges/s; tables and every launch's count "
        "identical")


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

    # a converge capped at the diameter keeps the fused frontier loop
    # (#19/#20); an uncapped one then ends the cutoff on the column pass
    cap_leaves = rng.integers(0, n_leaf, max(1, args.rank1_ops // 64))
    cap_vals = rng.integers(-550, 550, cap_leaves.size)
    batches.append((cap_leaves, cap_vals))
    sim.put_bulk(rng.integers(0, p, cap_leaves.size).astype(np.int32),
                 slot_of_leaf[cap_leaves], cap_vals)
    loops = _build.LAUNCHES["frontier_round_packed"]
    with window("rank1 capped converge", secs):
        cap_rounds = sim.run_until_converged(max_rounds=p // 2)
        cap_left = sim.last_residual
        sim.run_until_converged()
    if _build.LAUNCHES["frontier_round_packed"] == loops:
        raise AssertionError("the rank1 capped converge did not take the frontier loop")
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("the rank1 capped converge and its finish did not converge")
    n_written = check_values("capped converge")
    log(f"  put_bulk {cap_leaves.size} ops + run_until_converged(max_rounds={p // 2}): "
        f"{cap_rounds} rounds, residual {cap_left}; then to the fixed point: "
        f"{secs['rank1 capped converge']:.3f} s for both; {n_written} leaves == numpy max")

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


# ------------------------------------------------------------------ phase 7


def own_writes(op_peer, op_leaf, op_val, peer):
    """What ``peer`` applied itself in its first batch, per leaf: (leaf,
    ctr) of its winning op (the largest value, then the largest Lamport
    stamp; its stamps count 1, 2, ... in batch order). Lean gossip never
    moves writer, ctr or tick, so the converged row still holds these."""
    mine = np.flatnonzero(op_peer == peer)
    leaf, _, _, ctr = expected_winners(op_peer[mine], op_leaf[mine], op_val[mine])
    return leaf, ctr


def lean_main_path(args, dev, window=wall_window):
    """Phase 7: a lean dense ring at P x N (default 1024 x 2^20)."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    p, n = args.peers, args.lean_capacity
    secs: dict = {}
    rng = np.random.default_rng(args.seed + 3)
    sim = PeerNetworkSim(p, capacity=n, topology="ring", layout="dense", lean_gossip=True,
                         device=dev)
    n_leaf = n - 256
    slot_of_leaf = sim.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
    op_peer = rng.integers(0, p, args.lean_ops).astype(np.int32)
    op_leaf = rng.integers(0, n_leaf, args.lean_ops)
    op_val = rng.integers(-500, 500, args.lean_ops)
    batches = [(op_leaf, op_val)]

    _build.reset_launches()
    with window("lean put", secs):
        sim.put_bulk(op_peer, slot_of_leaf[op_leaf], op_val)
        sim.put(5, "s/name", "alice")
        sim.put(p - 1, "s/name", "bob")
        sim.put(p // 2, "s/obj", {"a": 1, "b": "x"})
    with window("lean step(1)", secs):
        residual = sim.step(1)
    with window("lean run_until_converged", secs):
        rounds = sim.run_until_converged()
    route = sim._convergence_strategy()[0]
    conv = secs["lean run_until_converged"]
    log(f"  put_bulk {args.lean_ops} ops + 3 string/object puts: {secs['lean put']:.3f} s (host)")
    log(f"  step(1) (apply + 1 lean round): {secs['lean step(1)']:.3f} s, residual {residual}")
    log(f"  run_until_converged [{route}]: {rounds} rounds in {conv:.3f} s "
        f"({1000 * conv / max(rounds, 1):.3f} ms/round)")
    if route != "dense-frontier" or _build.LAUNCHES["ring_round_lean"] != 1:
        raise AssertionError(f"lean main path took the {route} route, "
                             f"{_build.LAUNCHES['ring_round_lean']} lean rounds")
    if sim.last_residual != 0 or not sim.tables_equal():
        raise AssertionError("lean run_until_converged did not reach the fixed point")
    if not all(bool((f == f[0:1]).all()) for f in sim.table[:4]):
        raise AssertionError("converged lean rows differ in a value key")
    n_written = check_leaf_values(sim, batches, slot_of_leaf, rng, "lean converge")
    if sim.get(3, "s") != {"name": "bob", "obj": {"a": 1, "b": "x"}}:
        raise AssertionError(f"lean string/object puts: {sim.get(3, 's')}")
    # writer, ctr and tick: each sampled row holds its own writes only
    sampled = rng.choice(p, 8, replace=False)
    for q in sampled.tolist():
        leaf, ctr = own_writes(op_peer, op_leaf, op_val, q)
        slots = slot_of_leaf[leaf]
        meta = [f[q].cpu().numpy() for f in sim.table[4:]]
        mine = np.zeros(n_leaf, bool)  # over the k/ leaves
        mine[leaf] = True
        ok = (np.array_equal(meta[0][slots], np.full(len(slots), q))
              and np.array_equal(meta[1][slots], ctr) and bool((meta[2][slots] == 1).all())
              and not any(bool(m[slot_of_leaf[~mine]].any()) for m in meta))
        if not ok:
            raise AssertionError(f"lean: writer/ctr/tick of row {q} moved")
    log(f"  converged value keys == numpy per-leaf max over {n_written} written leaves; "
        f"writer/ctr/tick of {len(sampled)} sampled rows == what each peer applied itself")

    second_leaf = rng.integers(0, n_leaf, max(1, args.lean_ops // 16))
    second_val = rng.integers(-600, 600, len(second_leaf))
    batches.append((second_leaf, second_val))
    sim.put_bulk(rng.integers(0, p, len(second_leaf)).astype(np.int32),
                 slot_of_leaf[second_leaf], second_val)
    sim.put(7, "s/name", "carol")
    with window("lean reconcile", secs):
        sim.reconcile()
    if not sim.tables_equal() or sim.get(0, "s/name") != "carol":
        raise AssertionError("lean reconcile did not reach the fixed point")
    n_written = check_leaf_values(sim, batches, slot_of_leaf, rng, "lean reconcile")
    log(f"  reconcile (apply {len(second_leaf) + 1} late ops + {(p - 1).bit_length()} lean "
        f"doubling merges): {secs['lean reconcile']:.3f} s; {n_written} leaves == numpy "
        "per-leaf max")
    launches = {k: _build.LAUNCHES[k] for k in LEAN_KERNELS}
    log(f"  launches on the lean main path: {dict(_build.LAUNCHES)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"lean main path never launched: {missing}")
    return launches


# ------------------------------------------------------------------ phase 8


def sharded_equal(sharded, table) -> bool:
    """Every field of every shard equals the unsharded twin's rows."""
    b = sharded.rows
    return all(
        torch.equal(f, g[i * b:(i + 1) * b])
        for i, shard in enumerate(sharded.shards) for f, g in zip(shard, table)
    )


# the folds that end a mesh step: one launch each
FOLD_KERNELS = ("compact_counts", "compact_counts fused", "compact_counts window")


def launches_per_step(sim, twin, put, max_rounds: int, what: str) -> None:
    """Launches per mesh step of a sharded sim, counted outside every timed
    window: ``put(s)`` writes the same batch into the sim and its twin,
    step(0) applies it, and the sim's cutoff converge runs with its
    PyTorch operators counted, held equal to the twin's. Logs the port's
    kernel launches and the launching PyTorch operators (the boundary
    copies among them) a step, beside what the host's fold added before
    this change (counted by tools/time_rounds.py): a step's S + 1 zero
    fills and S adds, a window step's S + 1 zero fills, S adds, S maximums
    and 2 S copies."""
    from bullet_tpu_torch import _build

    for s in (sim, twin):
        put(s)
        s.step(0)
    before = dict(_build.LAUNCHES)
    with OpCount() as ops:
        got = (sim.run_until_converged(max_rounds=max_rounds), sim.last_residual)
    kernels = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    want = (twin.run_until_converged(max_rounds=max_rounds), twin.last_residual)
    if got != want or not sharded_equal(sim.table, twin.table):
        raise AssertionError(f"{what}: counted converge {got} against the twin's {want}")
    steps = max(1, sum(kernels.get(k, 0) for k in FOLD_KERNELS))
    torch_ops = ops.launching()
    shards = len(sim.table.shards)
    log(f"  {what}: launches per mesh step over {steps} steps of a cutoff converge: port "
        f"kernels {kernels} ({sum(kernels.values()) / steps:.2f} a step: the shards' steps and "
        f"one fold); launching PyTorch operators {torch_ops} "
        f"({sum(torch_ops.values()) / steps:.2f} a step, most of them the boundary copies); "
        f"before this change the fold added {2 * shards + 1} operators a step "
        f"({shards + 1} zero fills, {shards} adds) and {5 * shards + 1} a window step (also "
        f"{shards} maximums and {2 * shards} copies)")


def sharded_main_path(args, dev, window=wall_window):
    """Phase 8: ``SHARDS`` shards on the one card, P x N (default
    1024 x 2^18), lww (full metadata) and lean, against unsharded twins.
    Returns the launches of both runs, and under "frontier_shard fused
    lean" the lean run's fused launches (the kernel at nf = 4)."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    p, n = args.peers, args.capacity
    secs: dict = {}
    mesh = [dev] * SHARDS
    launches = {k: 0 for k in SHARD_KERNELS}
    for mode, lean in (("lww", False), ("reference", True)):
        tag = "lean" if lean else mode
        rng = np.random.default_rng(args.seed + 4)

        def make(**kw):
            return PeerNetworkSim(p, capacity=n, topology="ring", mode=mode, lean_gossip=lean,
                                  device=dev, **kw)

        sim, twin = make(mesh_devices=mesh, use_shard_map=True), make()
        n_leaf = n - 256
        op_peer = rng.integers(0, p, args.ops).astype(np.int32)
        op_leaf = rng.integers(0, n_leaf, args.ops)
        op_val = rng.integers(-500, 500, args.ops)
        slot_of_leaf = {}
        for s in (sim, twin):
            slot_of_leaf[s] = s.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
            s.put_bulk(op_peer, slot_of_leaf[s][op_leaf], op_val)
            s.put(5, "s/name", "alice")
            s.put(p - 1, "s/name", "bob")
            s.put(17, "s/n", 3.5)
            s.put(p // 2, "s/obj", {"a": 1, "b": "x"})
        route = sim._convergence_strategy()[0]
        if route != "dense-frontier-spmd":
            raise AssertionError(f"sharded {tag} sim takes the {route} route")
        _build.reset_launches()
        steps = None
        if not lean:  # a lean pair runs no step: see below
            with window(f"{tag} sharded step(1)", secs):
                steps = (sim.step(1), twin.step(1))
        with window(f"{tag} sharded run_until_converged", secs):
            rounds = sim.run_until_converged()
        with window(f"{tag} twin run_until_converged", secs):
            twin_rounds = twin.run_until_converged()
        residuals = (sim.last_residual, twin.last_residual)
        if ((steps and steps[0] != steps[1]) or rounds != twin_rounds or residuals != (0, 0)
                or not sharded_equal(sim.table, twin.table)):
            raise AssertionError(f"sharded {tag} converge differs from the twin: steps {steps}, "
                                 f"rounds {rounds} vs {twin_rounds}, residuals {residuals}")
        if not lean:
            # on a mesh converged() runs the full-metadata exchange round, so
            # a lean pair would differ by the reference's own rules
            with window(f"{tag} sharded converged()", secs):
                done = sim.converged()
            if not done or not twin.converged():
                raise AssertionError(f"sharded {tag}: converged() is False")
        # a cutoff: one fused step and a tail of single rounds
        more = max(1, args.ops // 16)
        leaf2, val2 = rng.integers(0, n_leaf, more), rng.integers(-600, 600, more)
        peer2 = rng.integers(0, p, more).astype(np.int32)
        cut = []
        for s in (sim, twin):
            s.put_bulk(peer2, slot_of_leaf[s][leaf2], val2)
            with window(f"{tag} {'sharded' if s is sim else 'twin'} cutoff converge", secs):
                cut.append((s.run_until_converged(max_rounds=12), s.last_residual))
        if cut[0] != cut[1] or not sharded_equal(sim.table, twin.table):
            raise AssertionError(f"sharded {tag} cutoff differs from the twin: {cut}")
        for s in (sim, twin):
            s.put(7, "s/name", "carol")
            with window(f"{tag} {'sharded' if s is sim else 'twin'} reconcile", secs):
                s.reconcile()
        if not sharded_equal(sim.table, twin.table) or not sim.tables_equal():
            raise AssertionError(f"sharded {tag} reconcile differs from the twin")
        sample = [f"k/{i}" for i in rng.integers(0, n_leaf, 64)] + ["s/name", "nope"]
        peers = rng.integers(0, p, len(sample))
        if (sim.get_bulk(peers, sample) != twin.get_bulk(peers, sample)
                or sim.get(3, "s") != twin.get(3, "s") or sim.get(0, "s/name") != "carol"):
            raise AssertionError(f"sharded {tag} reads differ from the twin")
        extra = np.random.default_rng(args.seed + 40)
        leaf3, val3 = extra.integers(0, n_leaf, more), extra.integers(-700, 700, more)
        launches_per_step(sim, twin, lambda s: s.put_bulk(peer2, slot_of_leaf[s][leaf3], val3), 12,
                          f"{tag} sharded")
        for k in SHARD_KERNELS:
            launches[k] += _build.LAUNCHES[k]
        if lean:
            launches["frontier_shard fused lean"] = _build.LAUNCHES["frontier_shard fused"]
        log(f"  {tag} ({'lean, ' if lean else ''}{SHARDS} shards of {p // SHARDS} x {n}"
            f" on one card): run_until_converged [{route}] {rounds} rounds in "
            f"{secs[f'{tag} sharded run_until_converged']:.3f} s (twin "
            f"{secs[f'{tag} twin run_until_converged']:.3f} s); cutoff at 12 rounds residual "
            f"{cut[0][1]}; reconcile {secs[f'{tag} sharded reconcile']:.3f} s (twin "
            f"{secs[f'{tag} twin reconcile']:.3f} s); every field, rounds, residuals and reads "
            "== the unsharded twin")
        if not lean:
            log(f"  {tag} step(1) of both, residual {steps[0]}: "
                f"{secs[f'{tag} sharded step(1)']:.3f} s; converged() sharded "
                f"{secs[f'{tag} sharded converged()']:.3f} s; both == the twin")
        log(f"  launches ({tag}): {dict(_build.LAUNCHES)}")
        del sim, twin
        torch.cuda.empty_cache()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"sharded path never launched: {missing}")
    return launches


# ------------------------------------------------------------------ phase 9


def sharded_packed_path(args, dev, window=wall_window, card=""):
    """Phase 9: ``SHARDS`` shards of the north-star table (P x N, default
    1024 x 2^20) on the one card, packed (12 B/entry) and rank1 (4 B/entry),
    each held against an unsharded twin. Returns (packed launches, rank1
    launches, windowed logical merges/s of the rank1 fast_forward)."""
    from bullet_tpu_torch import PeerNetworkSim, _build
    from bullet_tpu_torch.parallel.shardmap_gossip import (
        HALO_FUSE,
        gossip_frontier_shardmap_packed,
    )

    p, n = args.peers, args.packed_capacity
    secs: dict = {}
    mesh = [dev] * SHARDS
    n_leaf = n - 256
    rng = np.random.default_rng(args.seed + 5)

    def build(layout, sharded):
        kw = dict(mesh_devices=mesh, use_shard_map=True) if sharded else {}
        return PeerNetworkSim(p, capacity=n, topology="ring", layout=layout, device=dev, **kw)

    def load(sims, peers, leaves, vals):
        """The same puts into every sim (so their interners and rank
        indexes agree); returns each sim's slot of every leaf."""
        slots = {}
        for s in sims:
            slots[s] = s.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
            s.put_bulk(peers, slots[s][leaves], vals)
            s.put(5, "s/name", "alice")
            s.put(p - 1, "s/name", "bob")
            s.put(p // 2, "s/obj", {"a": 1, "b": "x"})
        return slots

    def equal(what, sim, twin, got, want):
        if got != want or not sharded_equal(sim.table, twin.table):
            raise AssertionError(f"phase 9 {what}: {got} against the twin's {want}")

    # packed: the column pass a shard against the unsharded one
    sim, twin = build("packed", True), build("packed", False)
    peers = rng.integers(0, p, args.packed_ops).astype(np.int32)
    leaves = rng.integers(0, n_leaf, args.packed_ops)
    vals = rng.integers(-500, 500, args.packed_ops)
    slots = load((sim, twin), peers, leaves, vals)
    batches = [(leaves, vals)]
    routes = (sim._convergence_strategy()[0], twin._convergence_strategy()[0])
    if routes != ("packed-frontier-spmd", "packed-frontier-local"):
        raise AssertionError(f"phase 9 packed routes {routes}")
    _build.reset_launches()
    with window("mesh packed step(1)", secs):
        r_sim = sim.step(1)
    with window("twin packed step(1)", secs):
        r_twin = twin.step(1)
    equal("packed step(1)", sim, twin, r_sim, r_twin)
    with window("mesh packed run_until_converged", secs):
        rounds = sim.run_until_converged()
    with window("twin packed run_until_converged", secs):
        twin_rounds = twin.run_until_converged()
    equal("packed converge", sim, twin, (rounds, sim.last_residual),
          (twin_rounds, twin.last_residual))
    if (sim.last_residual != 0 or not _build.LAUNCHES["column_summaries"]
            or not _build.LAUNCHES["settle_columns"]
            or _build.LAUNCHES["frontier_shard_window"]):
        raise AssertionError("phase 9 packed: not converged by the column pass")
    steps = _build.LAUNCHES["settle_columns"]
    n_written = check_leaf_values(sim, batches, slots[sim], rng, "phase 9 packed")
    log(f"  packed ({SHARDS} shards of {p // SHARDS} x {n} on one card, {12 * p * n / 1e9:.1f} GB"
        " + the twin): "
        f"step(1) residual {r_sim} in {secs['mesh packed step(1)']:.3f} s (twin "
        f"{secs['twin packed step(1)']:.3f} s); run_until_converged [{routes[0]}] {rounds} "
        f"rounds in {secs['mesh packed run_until_converged']:.3f} s, {steps} column passes "
        f"(twin [{routes[1]}] {secs['twin packed run_until_converged']:.3f} s); every field, "
        f"rounds and residual == the twin; {n_written} leaves == numpy per-leaf max")
    # a hot-range batch cut off at 70 rounds: one window of 63, a tail of 7
    more = 1 << 16
    leaves2 = rng.integers(0, min(n_leaf, 1 << 16), more)
    peers2, vals2 = rng.integers(0, p, more).astype(np.int32), rng.integers(-600, 600, more)
    cut = []
    for s, who in ((sim, "mesh"), (twin, "twin")):
        s.put_bulk(peers2, slots[s][leaves2], vals2)
        with window(f"{who} packed cutoff converge", secs):
            cut.append((s.run_until_converged(max_rounds=70), s.last_residual))
    equal("packed cutoff", sim, twin, cut[0], cut[1])
    with window("mesh packed converged()", secs):
        done = sim.converged()
    equal("packed converged()", sim, twin, done, twin.converged())
    for s, who in ((sim, "mesh"), (twin, "twin")):
        s.put(7, "s/name", "carol")
        with window(f"{who} packed reconcile", secs):
            s.reconcile()
    equal("packed reconcile", sim, twin, sim.converged(), True)
    sample = [f"k/{i}" for i in rng.integers(0, n_leaf, 64)] + ["s/name", "nope"]
    read_peers = rng.integers(0, p, len(sample))
    if (sim.get_bulk(read_peers, sample) != twin.get_bulk(read_peers, sample)
            or sim.get(3, "s") != twin.get(3, "s") or sim.get(0, "s/name") != "carol"):
        raise AssertionError("phase 9 packed reads differ from the twin")
    log(f"  packed cutoff at 70 rounds (apply 2^16 first): residual {cut[0][1]} in "
        f"{secs['mesh packed cutoff converge']:.3f} s (twin "
        f"{secs['twin packed cutoff converge']:.3f} s); converged() {done} in {secs['mesh packed converged()']:.3f} s; reconcile "
        f"{secs['mesh packed reconcile']:.3f} s (twin {secs['twin packed reconcile']:.3f} s); "
        "tables and reads == the twin")
    # drawn apart, so that the rank1 data below is the same with or without
    # this count
    extra = np.random.default_rng(args.seed + 50)
    leaves3 = extra.integers(0, min(n_leaf, 1 << 16), more)
    vals3 = extra.integers(-700, 700, more)
    launches_per_step(sim, twin, lambda s: s.put_bulk(peers2, slots[s][leaves3], vals3), 70,
                      "mesh packed")
    packed_launches = dict(_build.LAUNCHES)
    log(f"  launches (packed): {packed_launches}")
    del sim, twin
    torch.cuda.empty_cache()

    # rank1: the column pass a shard, the fused (HALO_FUSE) route on a
    # restored copy, and the spmd fast_forward against step on the twin
    sim, copy, twin = build("rank1", True), build("rank1", True), build("rank1", False)
    peers = rng.integers(0, p, args.rank1_ops).astype(np.int32)
    leaves = rng.integers(0, n_leaf, args.rank1_ops)
    vals = rng.integers(-500, 500, args.rank1_ops)
    slots = load((sim, copy, twin), peers, leaves, vals)
    _build.reset_launches()
    with window("mesh rank1 step(1)", secs):
        residual = sim.step(1)
    snap = sim.snapshot()
    for s in (copy, twin):
        s.restore(snap)
    with window("mesh rank1 run_until_converged", secs):
        rounds = sim.run_until_converged()
    with window("twin rank1 run_until_converged", secs):
        twin_rounds = twin.run_until_converged()
    route = sim._convergence_strategy()[0]
    equal("rank1 converge", sim, twin, (route, rounds, sim.last_residual),
          ("packed-frontier-spmd", twin_rounds, 0))
    t_total = n // copy._frontier_tile()
    with window("mesh rank1 fused converge", secs):
        _, fused_rounds, fused_last = gossip_frontier_shardmap_packed(
            copy.table, torch.ones(t_total, dtype=torch.bool, device=dev), True,
            2 * copy.topology.diameter + 2, fuse=HALO_FUSE, tile_n=copy._frontier_tile())
    equal("rank1 fused converge", copy, twin, (fused_rounds, fused_last), (twin_rounds, 0))
    check_leaf_values(sim, [(leaves, vals)], slots[sim], rng, "phase 9 rank1")
    log(f"  rank1 ({SHARDS} shards of {p // SHARDS} x {n}, {4 * p * n / 1e9:.1f} GB): step(1) "
        f"residual {residual}; "
        f"run_until_converged [{route}] {rounds} rounds in "
        f"{secs['mesh rank1 run_until_converged']:.3f} s (twin "
        f"{secs['twin rank1 run_until_converged']:.3f} s); a restored copy converged by "
        f"gossip_frontier_shardmap_packed(fuse={HALO_FUSE}) in "
        f"{secs['mesh rank1 fused converge']:.3f} s; both == the twin")
    # fast_forward(480) from the step(1) state: the spmd window route
    for s in (copy, twin):
        s.restore(snap)
    del snap, sim
    depth = min(480, p // 2 - 1)
    ff_route = copy._fast_forward_route()
    with window("mesh rank1 fast_forward(k)", secs):
        r_ff = copy.fast_forward(depth)
    with window("twin rank1 step(k)", secs):
        r_step = twin.step(depth)
    equal(f"rank1 fast_forward({depth}) [{ff_route}]", copy, twin, (ff_route, r_ff),
          ("spmd", r_step))
    ff = secs["mesh rank1 fast_forward(k)"]
    rate = 2 * p * n * depth / ff
    log(f"  rank1 fast_forward({depth}) [spmd]: {ff:.4f} s == step({depth}) on the twin "
        f"{secs['twin rank1 step(k)']:.3f} s (tables identical, residual {r_ff}); windowed "
        f"logical merges/s (2 x {p} x {n} x {depth} / s): {rate:.6g} on {card}")
    rank1_launches = dict(_build.LAUNCHES)
    log(f"  launches (rank1): {rank1_launches}")
    del copy, twin
    torch.cuda.empty_cache()
    missing = [k for k in MESH_PACKED_KERNELS if packed_launches[k] + rank1_launches[k] <= 0]
    if missing:
        raise AssertionError(f"phase 9 never launched: {missing}")
    return packed_launches, rank1_launches, rate


# ----------------------------------------------------------------- phase 10

ROLES = ("admin", "user", "editor")
CATEGORIES = ("electronics", "accessories", "furniture", "books")
# the bytes a replica entry stores: dense 7 fields, packed 3, rank1 1
ENTRY_BYTES = {"dense": 28, "packed": 12, "rank1": 4}
# the kernels phase 10 runs before it queries: the dense sim's step(1) and
# converge, the packed and rank1 sims' apply, step(1) and converge (the
# column pass), the mesh's converge (the column pass a shard)
QUERY_PATH_KERNELS = ("ring_round", "frontier_round_dense", "apply_packed", "packed_round",
                      "converge_columns", "column_summaries", "settle_columns")


def query_batches(rng, p: int, n: int):
    """Phase 10's writes for a table of n slots, the shape of the upstream
    query fixture (examples/query_example.py): n/8 users {name, age,
    active, role}, n/32 products {name, price, stock, category} and n/8
    leaf-form scores, at most 29 n / 32 + 3 paths (the table never grows);
    every record at one random peer; 4% of the users lack an age and 2%
    carry a bool one (JS coercion); then 3% of the roles, ages and prices
    written again from other peers. A list of (peers, paths, values)
    put_bulk calls: numeric arrays, or lists of strings or bools."""
    users, products, scores = n >> 3, n >> 5, n >> 3
    up, pp, sp = (rng.integers(0, p, k).astype(np.int32) for k in (users, products, scores))
    uid, pid = np.arange(users), np.arange(products)

    def paths(base, ids, field=None):
        return [f"{base}/{i}/{field}" if field else f"{base}/{i}" for i in ids.tolist()]

    def pick(choices, k):
        return [choices[i] for i in rng.integers(0, len(choices), k).tolist()]

    ages = rng.integers(18, 81, users)
    draw = rng.random(users)
    numeric, boolean = draw >= 0.06, (draw >= 0.04) & (draw < 0.06)
    out = [
        (up, paths("users", uid, "name"), [f"name{i}" for i in rng.integers(0, 4096, users)]),
        (up[numeric], paths("users", uid[numeric], "age"), ages[numeric]),
        (up[boolean], paths("users", uid[boolean], "age"), pick((True, False), int(boolean.sum()))),
        (up, paths("users", uid, "active"), pick((True, False), users)),
        (up, paths("users", uid, "role"), pick(ROLES, users)),
        (pp, paths("products", pid, "name"), [f"product{i % 1000}" for i in pid.tolist()]),
        (pp, paths("products", pid, "price"), np.round(rng.uniform(1, 2000, products), 2)),
        (pp, paths("products", pid, "stock"), rng.integers(0, 500, products)),
        (pp, paths("products", pid, "category"), pick(CATEGORIES, products)),
        (sp, paths("scores", np.arange(scores)), rng.integers(0, 1000, scores)),
    ]
    again = rng.choice(users, users * 3 // 100, replace=False)
    out.append((rng.integers(0, p, len(again)).astype(np.int32), paths("users", again, "role"),
                pick(ROLES, len(again))))
    again = rng.choice(uid[numeric], len(again), replace=False)
    out.append((rng.integers(0, p, len(again)).astype(np.int32), paths("users", again, "age"),
                rng.integers(18, 81, len(again))))
    again = rng.choice(products, products * 3 // 100, replace=False)
    out.append((rng.integers(0, p, len(again)).astype(np.int32), paths("products", again, "price"),
                np.round(rng.uniform(1, 2000, len(again)), 2)))
    return out


def query_plan(P):
    """(label, the call, its base, the predicate that decides it on the
    host, the answer's kind: a sorted path list, a count or the first
    hit)."""
    busy = (P["age"] >= 30) & (P["role"] == "user")
    return [
        ("equals users role admin", lambda s, q: s.equals(q, "users", "role", "admin"),
         "users", P["role"] == "admin", "list"),
        ("equals users active True", lambda s, q: s.equals(q, "users", "active", True),
         "users", P["active"] == True, "list"),  # noqa: E712 - the DSL
        ("range users age 30..39", lambda s, q: s.range(q, "users", "age", 30, 39),
         "users", P["age"].between(30, 39), "list"),
        ("range products price 100..500",
         lambda s, q: s.range(q, "products", "price", 100.0, 500.0),
         "products", P["price"].between(100.0, 500.0), "list"),
        ("equals scores 500 (leaf)", lambda s, q: s.equals(q, "scores", 500),
         "scores", P.value() == 500, "list"),
        ("range scores 100..199 (leaf)", lambda s, q: s.range(q, "scores", 100, 199),
         "scores", P.value().between(100, 199), "list"),
        ("count scores 500 (leaf)", lambda s, q: s.count(q, "scores", 500),
         "scores", P.value() == 500, "count"),
        ("count users role user", lambda s, q: s.count(q, "users", "role", "user"),
         "users", P["role"] == "user", "count"),
        ("filter (age >= 30) & (role == user)", lambda s, q: s.filter(q, "users", busy),
         "users", busy, "list"),
        ("count ~has(age)", lambda s, q: s.count(q, "users", ~P.has("age")),
         "users", ~P.has("age"), "count"),
        ("find products price < 50", lambda s, q: s.find(q, "products", P["price"] < 50.0),
         "products", P["price"] < 50.0, "find"),
        ("SimPeer count role editor", lambda s, q: s.peer(q).count("users", "role", "editor"),
         "users", P["role"] == "editor", "count"),
    ]


def host_answer(sim, peer: int, base: str, pred, kind: str, cache: dict):
    """The host oracle: ``pred.evaluate`` of every child of ``base`` the
    path interner knows, its value decoded at ``peer`` by ``get`` (None
    where the peer's row holds none of it: a negation matches such a child,
    as on the device). Returns (answer, get seconds, scan seconds); the
    decoded subtree is cached in ``cache`` by (peer, base)."""
    got = cache.get((peer, base))
    t_get = 0.0
    if got is None:
        start = time.perf_counter()
        data = sim.get(peer, base)
        t_get = time.perf_counter() - start
        pid = sim.host.paths.lookup(base)
        kids = np.flatnonzero(sim.host.struct_np()[0] == pid)
        keys = [sim.host.paths.segment(int(k)) for k in kids]
        got = cache[(peer, base)] = (data if isinstance(data, dict) else {}, keys)
    data, keys = got
    start = time.perf_counter()
    hits = sorted(f"{base}/{k}" for k in keys if pred.evaluate(data.get(k)))
    answer = {"list": hits, "count": len(hits), "find": hits[0] if hits else None}[kind]
    return answer, t_get, time.perf_counter() - start


def run_queries(tag: str, sims, peers, card: str):
    """Every query of ``query_plan`` at each of ``peers`` on ``sims[0]``
    (the others, a twin, must answer the same), held against the host
    oracle; logs each query's host-inclusive ms at each peer, its PyTorch
    operators (counted on a second call), the oracle's get + scan ms and
    the row's byte bound. Raises on any difference."""
    from bullet_tpu_torch import P

    sim = sims[0]
    n = sim._shape()[1]
    row_bound = 1e3 * n * ENTRY_BYTES[sim.layout] / HBM_BYTES_PER_S
    cache: dict = {}
    for label, call, base, pred, kind in query_plan(P):
        ms, host_ms, counted = [], [], set()
        for q in peers:
            secs: dict = {}
            with wall_window("query", secs):
                got = call(sim, q)
            ms.append(1e3 * secs["query"])
            with OpCount() as ops:
                again = call(sim, q)
            counted.add(sum(ops.counts.values()))
            want, t_get, t_scan = host_answer(sim, q, base, pred, kind, cache)
            host_ms.append(1e3 * (t_get + t_scan))
            twins = [call(t, q) for t in sims[1:]]
            if got != want or again != got or any(t != got for t in twins):
                raise AssertionError(f"phase 10 {tag} {label} at peer {q}: {str(got)[:200]} "
                                     f"against the oracle's {str(want)[:200]}")
        size = len(got) if isinstance(got, list) else got
        log(f"    {label}: {size} at peer {peers[-1]}; ms "
            f"{' / '.join(f'{t:.3f}' for t in ms)}; operators {sorted(counted)}; "
            f"get + scan ms {' / '.join(f'{t:.1f}' for t in host_ms)}; "
            f"row bound {row_bound:.3g} ms")
    log(f"    ({tag}: peers {' / '.join(map(str, peers))}, {card})")


def query_path(args, dev, card: str):
    """Phase 10: the queries on the card, on packed and rank1 sims at
    P x N (default 1024 x 2^20), a dense sim at 1024 x 2^18 and a 4-shard
    packed mesh on the one card against its unsharded twin; each after
    step(1) (rows differ from peer to peer) and after the converge.
    Returns the launches of the whole phase."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    p = args.peers
    peers = (0, p // 2, p - 1)
    _build.reset_launches()
    cells = (("packed", args.packed_capacity, False), ("rank1", args.rank1_capacity, False),
             ("dense", args.capacity, False), ("packed", args.packed_capacity, True))
    for layout, n, mesh in cells:
        rng = np.random.default_rng(args.seed + 10)
        batches = query_batches(rng, p, n)
        tag = f"{layout} {p} x {n}" + (f", {SHARDS} shards on one card" if mesh else "")
        make = [dict(mesh_devices=[dev] * SHARDS, use_shard_map=True), {}] if mesh else [{}]
        sims = [PeerNetworkSim(p, capacity=n, topology="ring", layout=layout, device=dev, **kw)
                for kw in make]
        secs: dict = {}
        with wall_window("load", secs):
            for s in sims:
                for batch in batches:
                    s.put_bulk(*batch)
        with wall_window("step(1)", secs):
            residual = [s.step(1) for s in sims]
        if sims[0].capacity != n or len(set(residual)) != 1:
            raise AssertionError(f"phase 10 {tag}: capacity {sims[0].capacity}, residuals "
                                 f"{residual}")
        log(f"  {tag}: {len(sims[0].host.paths)} paths, {sum(len(b[0]) for b in batches)} "
            f"writes in {len(batches)} put_bulk calls, loaded in {secs['load']:.2f} s; "
            f"step(1) residual {residual[0]}")
        run_queries(f"{tag}, after step(1)", sims, peers, card)
        with wall_window("converge", secs):
            rounds = [s.run_until_converged() for s in sims]
        if len(set(rounds)) != 1 or any(s.last_residual for s in sims):
            raise AssertionError(f"phase 10 {tag}: converge {rounds}")
        log(f"  {tag}: run_until_converged [{sims[0]._convergence_strategy()[0]}] "
            f"{rounds[0]} rounds")
        run_queries(f"{tag}, converged", sims, peers, card)
        del sims
        torch.cuda.empty_cache()
    launches = dict(_build.LAUNCHES)
    log(f"  launches (phase 10): {launches}")
    missing = [k for k in QUERY_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"phase 10 never launched: {missing}")
    return launches


# ----------------------------------------------------------------- phase 11

# the two schemas of examples/validation_example.py:19-52 (bullet-js's
# validation example), bound to users and products
USER_SCHEMA = {
    "type": "object",
    "required": ["username", "email"],
    "properties": {
        "username": {"type": "string", "min": 3, "max": 20},
        "email": {"type": "string", "format": "email"},
        "age": {"type": "integer", "min": 13, "max": 120},
        "role": {"type": "string", "enum": ["admin", "user", "editor"]},
        "verified": {"type": "boolean"},
        "profile": {
            "type": "object",
            "properties": {
                "bio": {"type": "string", "max": 100},
                "website": {"type": "string", "format": "url"},
            },
        },
    },
}
PRODUCT_SCHEMA = {
    "type": "object",
    "required": ["name", "price"],
    "properties": {
        "name": {"type": "string"},
        "price": {"type": "number", "min": 0},
        "sku": {"type": "string", "pattern": r"^[A-Z]{3}-\d{4}$"},
        "even_stock": {"type": "integer", "validators": [lambda v: v % 2 == 0]},
    },
}
USER_ROLES = ("admin", "user", "editor")
# phase 11's traced transform caps the prices here
PRICE_CAP = 1000.0
# the kernels each phase 11 sim drives: its apply, step(1), converge (the
# packed family's: the column pass, a shard's on the mesh) and reconcile
# (the dense apply is plain PyTorch)
INGRESS_KERNELS = {
    "packed": ("apply_packed", "packed_round", "converge_columns", "reconcile_packed"),
    "rank1": ("apply_packed", "packed_round", "converge_columns", "reconcile_packed"),
    "dense": ("ring_round", "frontier_round_dense", "merge"),
    "mesh": ("apply_packed", "frontier_shard packed", "column_summaries", "settle_columns",
             "reconcile_packed"),
}


def ingress_batches(rng, p: int, n: int):
    """Phase 11's writes for a table of n slots, in phase 10's shape: n/8
    users {username, age, role, verified} and n/32 products {name, price,
    stock, category}, every record at one random peer, with a known share
    of values that break the schemas: ages outside [13, 120] 2%,
    non-integral ages 1%, booleans in age 1%, roles outside the enum 1%,
    strings in verified 1%, usernames shorter than 3 or longer than 20 1%,
    negative prices 1%; then 1% of the users written again at the same
    peer with age 500, which would win its (peer, slot) were it not vetoed.
    A list of (field, peers, paths, values) put_bulk calls: numeric arrays,
    or lists."""
    users, products = n >> 3, n >> 5
    up, pp = (rng.integers(0, p, k).astype(np.int32) for k in (users, products))
    uid, pid = np.arange(users), np.arange(products)

    def paths(base, ids, field):
        return [f"{base}/{i}/{field}" for i in ids.tolist()]

    def pick(choices, k):
        return [choices[i] for i in rng.integers(0, len(choices), k).tolist()]

    def share(k, *fractions):
        draw = rng.random(k)
        edges = np.cumsum((0.0,) + fractions)
        return [(draw >= lo) & (draw < hi) for lo, hi in zip(edges[:-1], edges[1:])]

    names = [f"user{i}" for i in rng.integers(0, 1 << 20, users).tolist()]
    short, long_ = share(users, 0.005, 0.005)
    for i in np.flatnonzero(short).tolist():
        names[i] = "ab"
    for i in np.flatnonzero(long_).tolist():
        names[i] = "u" * 21
    ages = rng.integers(13, 121, users).astype(np.float64)
    out_of_range, fraction, boolean = share(users, 0.02, 0.01, 0.01)
    ages[out_of_range] = np.where(rng.random(int(out_of_range.sum())) < 0.5,
                                  rng.integers(0, 13, int(out_of_range.sum())),
                                  rng.integers(121, 300, int(out_of_range.sum())))
    ages[fraction] += 0.5
    numeric = ~boolean
    roles = pick(USER_ROLES, users)
    for i in np.flatnonzero(share(users, 0.01)[0]).tolist():
        roles[i] = "superuser"
    verified = pick((True, False), users)
    for i in np.flatnonzero(share(users, 0.01)[0]).tolist():
        verified[i] = "yes"
    prices = np.round(rng.uniform(1, 2000, products), 2)
    negative = share(products, 0.01)[0]
    prices[negative] = -prices[negative]
    again = rng.choice(uid[numeric], users // 100, replace=False)
    return [
        ("username", up, paths("users", uid, "username"), names),
        ("age", up[numeric], paths("users", uid[numeric], "age"), ages[numeric]),
        ("age", up[boolean], paths("users", uid[boolean], "age"),
         pick((True, False), int(boolean.sum()))),
        ("role", up, paths("users", uid, "role"), roles),
        ("verified", up, paths("users", uid, "verified"), verified),
        ("name", pp, paths("products", pid, "name"), [f"product{i % 1000}" for i in pid.tolist()]),
        ("price", pp, paths("products", pid, "price"), prices),
        ("stock", pp, paths("products", pid, "stock"), rng.integers(0, 500, products)),
        ("category", pp, paths("products", pid, "category"), pick(CATEGORIES, products)),
        ("age", up[again], paths("users", again, "age"), np.full(len(again), 500.0)),
    ]


def oracle_keep(field: str, values) -> np.ndarray:
    """The independent oracle: which values pass the schemas' type,
    min/max, enum, integer, boolean and length constraints (the ones the
    bulk path enforces), decided in Python, value by value."""
    def number(v):
        return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)

    rules = {
        "username": lambda v: isinstance(v, str) and 3 <= len(v) <= 20,
        "age": lambda v: number(v) and float(v) == int(v) and 13 <= v <= 120,
        "role": lambda v: isinstance(v, str) and v in USER_ROLES,
        "verified": lambda v: isinstance(v, bool),
        "price": lambda v: number(v) and v >= 0,
    }
    rule = rules.get(field, lambda v: True)
    seq = values.tolist() if isinstance(values, np.ndarray) else values
    return np.fromiter((rule(v) for v in seq), dtype=bool, count=len(seq))


def bind_schemas(sim, errors: list):
    sim.define_schema("user", USER_SCHEMA)
    sim.define_schema("product", PRODUCT_SCHEMA)
    sim.apply_schema("users", "user")
    sim.apply_schema("products", "product")
    sim.on_validation_error("all", errors.append)


def kept_rows(batch, keep):
    """The (peers, paths, values) of ``batch``'s rows where ``keep``."""
    _, peers, paths, values = batch
    vals = values[keep] if isinstance(values, np.ndarray) else [
        v for v, k in zip(values, keep.tolist()) if k]
    return peers[keep], [q for q, k in zip(paths, keep.tolist()) if k], vals


def pre_intern(twin, batch):
    """What the sim's put_bulk interns of a batch whose rows the twin does
    not all get: its paths, then its values, in the sim's order, so that
    both sims hold the same slot and value ids."""
    from bullet_tpu_torch.utils.encode import bulk_encode_numbers, bulk_encode_values

    _, _, paths, values = batch
    twin.host.intern_batch(paths)
    if isinstance(values, np.ndarray):
        bulk_encode_numbers(twin.host.values, values)
    else:
        bulk_encode_values(twin.host.values, list(values))


def timed_method(obj, name: str, secs: dict, sync: bool) -> None:
    """Replace ``obj.name`` by a wrapper that adds its wall seconds (the
    device drained at both ends) to ``secs[name]``."""
    real = getattr(obj, name)
    secs.setdefault(name, 0.0)

    def run(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            if sync:
                torch.cuda.synchronize()
            secs[name] += time.perf_counter() - start

    setattr(obj, name, run)


def tables_same(a, b) -> bool:
    """Two sims' tables equal, field by field, on the device (a sharded
    one against its unsharded twin's rows)."""
    from bullet_tpu_torch.parallel.mesh import ShardedTable

    if isinstance(a.table, ShardedTable):
        return sharded_equal(a.table, b.table)
    return all(torch.equal(f, g) for f, g in zip(a.table, b.table))


def check_reads(tag: str, sims, paths, peers, want) -> None:
    """get_bulk of ``paths`` at each of ``peers`` on every sim equals
    ``want`` (one value a path: every peer holds it once converged)."""
    for q in peers:
        for s in sims:
            got = s.get_bulk(np.full(len(paths), q, dtype=np.int32), paths)
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
                raise AssertionError(f"phase 11 {tag}: {paths[bad]} at peer {q} reads "
                                     f"{got[bad]!r}, want {want[bad]!r}")


def ingress_pair(tag, layout, p, n, dev, batches, window, card, mesh=False):
    """A sim with the schemas beside a twin: without them and given only
    the ops the oracle keeps, or (``mesh``) a 4-shard sim beside an
    unsharded twin that both carry the schemas and get every op. Holds
    ops_rejected and the error handler's count to the oracle's, then the
    tables exactly after step(1), the converge and reconcile; reads a
    sample at three peers against the oracle's values. Logs put_bulk's
    host seconds, step(1) against the twin's, the ingress round trip and
    report_rejections. Returns the kernels it launched, with counts."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    sync = dev.type == "cuda"
    errors, twin_errors = [], []
    extra = dict(mesh_devices=[dev] * SHARDS, use_shard_map=True) if mesh else {}
    sim = PeerNetworkSim(p, capacity=n, topology="ring", layout=layout, device=dev, **extra)
    twin = PeerNetworkSim(p, capacity=n, topology="ring", layout=layout, device=dev)
    bind_schemas(sim, errors)
    if mesh:
        bind_schemas(twin, twin_errors)
    else:
        for base in ("users", "products"):
            twin.intern_path(base)
    secs: dict = {}
    for name in ("_ingress_flat", "_ingress"):
        timed_method(sim, name, secs, sync)
    timed_method(sim.validation, "report_rejections", secs, sync)
    before = dict(_build.LAUNCHES)
    keeps = [oracle_keep(b[0], b[3]) for b in batches]
    with window("put_bulk", secs):
        for batch in batches:
            sim.put_bulk(*batch[1:])
    with window("twin put_bulk", secs):
        for batch, keep in zip(batches, keeps):
            if mesh:
                twin.put_bulk(*batch[1:])
            else:
                pre_intern(twin, batch)
                twin.put_bulk(*kept_rows(batch, keep))
    rejected = int(sum(len(k) - int(k.sum()) for k in keeps))
    # put_bulk drops what the device cannot judge; the step vetoes the rest
    strict = sim.stats["ops_rejected"]
    if len(sim.host.values) != len(twin.host.values) or len(sim.host.paths) != len(
            twin.host.paths):
        raise AssertionError(f"phase 11 {tag}: the twin interned other ids")
    with window("step(1)", secs):
        residual = sim.step(1)
    with window("twin step(1)", secs):
        twin_residual = twin.step(1)
    got = (sim.stats["ops_rejected"], len(errors), sim.stats["ops_applied"], residual)
    want = (rejected, rejected, twin.stats["ops_applied"], twin_residual)
    if got != want or not tables_same(sim, twin):
        raise AssertionError(f"phase 11 {tag}: after step(1) (rejected, errors, applied, "
                             f"residual) {got}, want {want}, tables equal "
                             f"{tables_same(sim, twin)}")
    if mesh and twin.stats["ops_rejected"] != rejected:
        raise AssertionError(f"phase 11 {tag}: the twin rejected {twin.stats['ops_rejected']}")
    with window("converge", secs):
        rounds = sim.run_until_converged()
    twin_rounds = twin.run_until_converged()
    if rounds != twin_rounds or sim.last_residual or not tables_same(sim, twin):
        raise AssertionError(f"phase 11 {tag}: converge {rounds} against {twin_rounds}")
    route = sim._convergence_strategy()[0]
    sim.reconcile()
    twin.reconcile()
    if not tables_same(sim, twin) or not sim.tables_equal():
        raise AssertionError(f"phase 11 {tag}: reconcile")
    # every path's one kept value (the collisions' second write is vetoed)
    rng = np.random.default_rng(11)
    want_of = {}
    for batch, keep in zip(batches, keeps):
        vals = batch[3].tolist() if isinstance(batch[3], np.ndarray) else batch[3]
        for q, v, k in zip(batch[2], vals, keep.tolist()):
            if k:
                want_of[q] = v
            else:
                want_of.setdefault(q, None)
    all_paths = sorted(want_of)
    sample = [all_paths[i] for i in rng.choice(len(all_paths), min(4096, len(all_paths)),
                                               replace=False)]
    check_reads(tag, (sim, twin), sample, (0, p // 2, p - 1), [want_of[q] for q in sample])
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    # the flat path's timer holds the inner _ingress's
    ingress_s = secs["_ingress_flat"] or secs["_ingress"]
    report_s = secs["report_rejections"]
    vetoed = rejected - strict
    log(f"  {tag}: {sum(len(b[1]) for b in batches)} writes in {len(batches)} put_bulk calls, "
        f"{rejected} rejected ({sim.stats['ops_rejected']} counted, {len(errors)} typed "
        f"errors; {strict} dropped at put_bulk, {vetoed} vetoed on the device); put_bulk "
        f"{secs['put_bulk']:.3f} s host (twin {secs['twin put_bulk']:.3f} s); step(1) "
        f"{1e3 * secs['step(1)']:.1f} ms with ingress against the twin's "
        f"{1e3 * secs['twin step(1)']:.1f} ms; ingress round trip (upload, transforms, mask, "
        f"download) {1e3 * (ingress_s - report_s):.1f} ms, report_rejections "
        f"{1e3 * report_s:.1f} ms ({1e6 * report_s / max(vetoed, 1):.1f} us a vetoed op); "
        f"converge [{route}] {rounds} rounds {secs['converge']:.2f} s; {card}")
    return launches


def ingress_clamp_pair(tag, p, n, dev, batches, window, card):
    """A rank1 sim with a traced put transform in torch that caps every
    price at PRICE_CAP through its encoded key and vid, beside a twin given
    the prices capped in numpy; both intern the same values in the same
    order (the twin its raw prices too), so their rank tables must be
    equal."""
    from bullet_tpu_torch import PeerNetworkSim, _build
    from bullet_tpu_torch.utils.encode import CLS_NUMBER, number_key

    sync = dev.type == "cuda"
    sim = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device=dev)
    twin = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device=dev)
    cap_hi, cap_lo = number_key(PRICE_CAP)
    cap_vid = sim.host.encode_value(PRICE_CAP)[3]
    twin.host.encode_value(PRICE_CAP)
    price_sid = sim.host._seg_id("price")
    twin.host._seg_id("price")

    def clamp(ops, struct):
        is_price = struct.seg[ops.slot.long()] == price_sid
        big = is_price & (ops.cls == CLS_NUMBER) & (
            (ops.khi > cap_hi) | ((ops.khi == cap_hi) & (ops.klo > cap_lo)))
        return ops._replace(khi=torch.where(big, cap_hi, ops.khi),
                            klo=torch.where(big, cap_lo, ops.klo),
                            vid=torch.where(big, cap_vid, ops.vid))

    sim.use_traced_put(clamp)
    secs: dict = {}
    timed_method(sim, "_ingress_flat", secs, sync)
    before = dict(_build.LAUNCHES)
    with window("put_bulk", secs):
        for batch in batches:
            sim.put_bulk(*batch[1:])
    capped = 0
    with window("twin put_bulk", secs):
        for field, peers, paths, values in batches:
            if field == "price":
                pre_intern(twin, (field, peers, paths, values))
                capped = int((values > PRICE_CAP).sum())
                values = np.minimum(values, PRICE_CAP)
            twin.put_bulk(peers, paths, values)
    with window("step(1)", secs):
        residual = sim.step(1)
    with window("twin step(1)", secs):
        twin_residual = twin.step(1)
    if (residual, sim.stats["ops_applied"]) != (twin_residual, twin.stats["ops_applied"]) or \
            not tables_same(sim, twin):
        raise AssertionError(f"phase 11 {tag}: step(1) {residual} against {twin_residual}")
    with window("converge", secs):
        rounds = sim.run_until_converged()
    if rounds != twin.run_until_converged() or not tables_same(sim, twin):
        raise AssertionError(f"phase 11 {tag}: converge")
    sim.reconcile()
    twin.reconcile()
    if not tables_same(sim, twin):
        raise AssertionError(f"phase 11 {tag}: reconcile")
    _, _, paths, values = next(b for b in batches if b[0] == "price")
    want = np.minimum(values, PRICE_CAP).tolist()
    check_reads(tag, (sim,), paths[:4096], (0, p // 2, p - 1), want[:4096])
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    log(f"  {tag}: traced transform capped {capped} prices at {PRICE_CAP:g}; put_bulk "
        f"{secs['put_bulk']:.3f} s host (twin {secs['twin put_bulk']:.3f} s); step(1) "
        f"{1e3 * secs['step(1)']:.1f} ms with the transform against the twin's "
        f"{1e3 * secs['twin step(1)']:.1f} ms; ingress round trip (upload, transform, "
        f"download) {1e3 * secs['_ingress_flat']:.1f} ms; converge {rounds} rounds "
        f"{secs['converge']:.2f} s; {card}")
    return launches


def ingress_hooks(tag, p, n, dev, window, card):
    """A dense sim with host hooks: a put hook that vetoes secret/… and
    rewrites alias/… to real/…, afterPut and "write" counters, a get hook
    that rewrites alias/… reads to real/… and an afterGet transform that
    doubles the numbers it reads there; scalar and bulk puts, each held
    against the result computed in Python."""
    from bullet_tpu_torch import PeerNetworkSim, _build

    rng = np.random.default_rng(12)
    sim = PeerNetworkSim(p, capacity=n, topology="ring", device=dev)
    count = Counter()

    def put_hook(path, data):
        if path.startswith("secret/"):
            return False
        if path.startswith("alias/"):
            return {"path": "real/" + path[6:], "data": data}
        return None

    def after_put(path, data, peer):
        count["afterPut"] += 1

    def after_get(path, data):
        if path.startswith("real/") and isinstance(data, (int, float)):
            return 2 * data
        return None

    sim.use("put", put_hook)
    sim.use("afterPut", after_put)
    sim.use("get", lambda path, data: "real/" + path[6:] if path.startswith("alias/") else None)
    sim.use("afterGet", after_get)
    sim.on_event("write", lambda d: count.__setitem__("write", count["write"] + 1))
    users, k = n >> 3, n >> 6
    uid = np.arange(users)
    batches = [
        (rng.integers(0, p, users).astype(np.int32), [f"users/{i}/name" for i in uid.tolist()],
         [f"user{i}" for i in rng.integers(0, 1 << 20, users).tolist()]),
        (rng.integers(0, p, users).astype(np.int32), [f"users/{i}/age" for i in uid.tolist()],
         rng.integers(13, 121, users).astype(np.float64)),
        (rng.integers(0, p, k).astype(np.int32), [f"secret/{i}" for i in range(k)],
         rng.uniform(0, 1, k)),
        (rng.integers(0, p, k).astype(np.int32), [f"alias/{i}" for i in range(k)],
         np.round(rng.uniform(0, 100, k), 3)),
    ]
    want = {}
    accepted = 0
    secs: dict = {}
    with window("put_bulk", secs):
        for peers, paths, values in batches:
            sim.put_bulk(peers, paths, values)
    for peers, paths, values in batches:
        vals = values.tolist() if isinstance(values, np.ndarray) else values
        for q, v in zip(paths, vals):
            if q.startswith("secret/"):
                want[q] = None
                continue
            accepted += 1
            if q.startswith("alias/"):
                # stored at real/…; read there or through alias/…, doubled
                want["real/" + q[6:]] = want[q] = 2 * v
            else:
                want[q] = v
    scalar_ok = []
    with window("scalar puts", secs):
        for i in range(1000):
            q = ("secret/s", "alias/s", "scalar/")[i % 3] + str(i)
            v = float(i) + 0.25
            scalar_ok.append(sim.put(int(rng.integers(p)), q, v))
            if q.startswith("secret/"):
                want[q] = None
                continue
            accepted += 1
            if q.startswith("alias/"):
                want["real/" + q[6:]] = want[q] = 2 * v
            else:
                want[q] = v
    if scalar_ok != [i % 3 != 0 for i in range(1000)]:
        raise AssertionError(f"phase 11 {tag}: put's return values")
    if count["afterPut"] or count["write"]:
        raise AssertionError(f"phase 11 {tag}: afterPut fired before the step")
    before = dict(_build.LAUNCHES)
    with window("step(1)", secs):
        sim.step(1)
    if (count["afterPut"], count["write"]) != (accepted, accepted):
        raise AssertionError(f"phase 11 {tag}: afterPut {count['afterPut']}, write "
                             f"{count['write']}, want {accepted}")
    with window("converge", secs):
        rounds = sim.run_until_converged()
    sim.reconcile()
    if not sim.tables_equal():
        raise AssertionError(f"phase 11 {tag}: reconcile")
    paths = sorted(want)
    sample = [paths[i] for i in rng.choice(len(paths), min(4096, len(paths)), replace=False)]
    check_reads(tag, (sim,), sample, (0, p // 2, p - 1), [want[q] for q in sample])
    for q in sample[:64]:
        if sim.get(p - 1, q) != want[q]:
            raise AssertionError(f"phase 11 {tag}: get {q}")
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    log(f"  {tag}: {sum(len(b[0]) for b in batches)} bulk rows and 1000 scalar puts through "
        f"the put hook, {accepted} accepted, afterPut and write fired {accepted} times at the "
        f"step; put_bulk {secs['put_bulk']:.3f} s host, scalar puts "
        f"{1e3 * secs['scalar puts']:.1f} ms, step(1) {1e3 * secs['step(1)']:.1f} "
        f"ms (the afterPut delivery included), converge {rounds} rounds "
        f"{secs['converge']:.2f} s; {card}")
    return launches


def free(dev) -> None:
    """Return the freed sims' memory to the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def ingress_path(args, dev, card: str, window=wall_window):
    """Phase 11: batch ingress at full width. Packed P x N (default
    1024 x 2^20) with both schemas beside a twin given only the ops the
    oracle keeps; rank1 P x N with a traced transform in torch beside a
    twin given the capped values; dense P x 2^18 with host hooks against
    Python's expected results; a 4-shard rank1 mesh with the schemas
    beside its unsharded twin. Raises if a sim disagrees or a kernel of
    its path was never launched."""
    rng = np.random.default_rng(args.seed + 11)
    p = args.peers
    packed_batches = ingress_batches(rng, p, args.packed_capacity)
    launches = {}
    launches["packed"] = ingress_pair(
        f"packed {p} x {args.packed_capacity}, schemas", "packed", p, args.packed_capacity, dev,
        packed_batches, window, card)
    free(dev)
    rank1_batches = ingress_batches(rng, p, args.rank1_capacity)
    launches["rank1"] = ingress_clamp_pair(
        f"rank1 {p} x {args.rank1_capacity}, traced transform", p, args.rank1_capacity, dev,
        rank1_batches, window, card)
    free(dev)
    launches["dense"] = ingress_hooks(f"dense {p} x {args.capacity}, host hooks", p,
                                      args.capacity, dev, window, card)
    free(dev)
    launches["mesh"] = ingress_pair(
        f"rank1 {p} x {args.rank1_capacity}, {SHARDS} shards on one card, schemas", "rank1",
        p, args.rank1_capacity, dev, rank1_batches, window, card, mesh=True)
    free(dev)
    log(f"  launches (phase 11): {launches}")
    if dev.type == "cuda":
        missing = [f"{sim} {k}" for sim, names in INGRESS_KERNELS.items() for k in names
                   if launches[sim].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase 11 never launched: {missing}")
    return launches


# ----------------------------------------------------------------- phase 12

# the serving bench's flood (benchmarks/serving_bench.py:57-160): records
# cat/itemNNNNN {price, tier}, one in four gold, then 60 rounds of idle
# queries and 60 counts under a writer thread's price overwrites
SERVING_WRITES = 4000
SERVING_ROUNDS = 60
# the reference's loaded-count p95 bound (benchmarks/serving_bench.py:144-150),
# printed beside the measured p95, not asserted
SERVING_P95_BOUND_MS = 50.0
# the loaded flood's pace, a share of the first flood's wire rate: an
# unpaced writer fills its link's bounded outbox (10,000 frames) within a
# fraction of a second and the db layer drops the link (ROADMAP Queue 3)
LOADED_PACE = 0.5
# every wait of phase 12 ends by this many seconds or raises
SERVING_DEADLINE_S = 120.0
# the kernels phase 12 drives: the views' apply and the warm-up (#9/#10),
# flush's converge (the column pass), converged()'s count-only round (#14)
# and sim_from_bullet's dense converge (#8)
SERVING_KERNELS = ("apply_packed", "converge_columns", "packed_round",
                   "frontier_round_dense")
# the port's kernels in a device trace, by the names of their __global__
# functions (csrc/*.cu)
PORT_KERNEL_NAMES = (
    "apply_packed_kernel", "column_summaries_kernel", "compact_counts_kernel",
    "compact_counts_window_kernel", "converge_columns_kernel", "frontier_compact_kernel",
    "frontier_pipe_kernel", "settle_columns_kernel",
    "frontier_round_kernel", "frontier_shard_kernel", "frontier_shard_window_kernel", "merge_kernel",
    "packed_round_kernel", "reconcile_packed_kernel", "ring_round_kernel", "shard_pipe_kernel",
    "shard_sweep_kernel", "window_kernel",
)
# phase 12's checkpoints: P x 2^16 with phase 10's records cut to a sixteenth
CHECKPOINT_CAPACITY = 1 << 16
# phase 12's files (checkpoints, the trace) go under the checkout's build/
PHASE12_DIR = "build/phase12"


def wait_for(pred, what: str, timeout: float = SERVING_DEADLINE_S) -> None:
    """Poll ``pred`` until it holds; raise TimeoutError at the deadline."""
    start = time.perf_counter()
    while not pred():
        if time.perf_counter() - start > timeout:
            raise TimeoutError(f"phase 12: {what} not within {timeout:.0f} s")
        time.sleep(0.005)


def percentiles(samples, qs=(50, 95, 99)):
    """The ms at each percentile of ``samples`` (seconds)."""
    return {q: 1e3 * float(np.percentile(np.asarray(samples), q)) for q in qs}


def price_scan(prices: dict, lo: float, hi: float):
    """The sorted cat paths whose price lies in [lo, hi]: the host scan the
    views' range is held to."""
    return sorted(f"cat/{k}" for k, v in prices.items() if lo <= v <= hi)


def serving_mirror(args, dev, card: str) -> None:
    """Phase 12 (a), (c) and (d): two port Bullets on 127.0.0.1, a writer
    and a serving peer, the serving peer mirrored into a rank1 P x N ring
    (preloaded at peer 0 with phase 10's records and converged) through
    ``attach_live_bridge``, the bench's flood and queries through the
    view, the checks after it, then the bridge and serializer against the
    serving store and a device trace of one converge."""
    from bullet_tpu_torch import PeerNetworkSim, create
    from bullet_tpu_torch.models.bridge import attach_live_bridge
    from bullet_tpu_torch.utils.observe import StepObserver, profile_trace

    p, n = args.peers, args.rank1_capacity
    rng = np.random.default_rng(args.seed + 12)
    secs: dict = {}
    sim = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device=dev)
    with wall_window("preload", secs):
        for _, paths, values in query_batches(rng, p, n):
            sim.put_bulk(np.zeros(len(paths), dtype=np.int32), paths, values)
        rounds = sim.run_until_converged()
    log(f"  (a) rank1 {p} x {n} preloaded at peer 0 with {len(sim.host.paths)} paths, "
        f"converged in {rounds} rounds, {secs['preload']:.2f} s")
    options = {"storage": False, "host": "127.0.0.1", "port": 0, "connect_sync_delay": 600}
    serving = create(dict(options))
    writer = handle = None
    try:
        writer = create(dict(options, peers=[f"tcp://127.0.0.1:{serving.network.port}"]))
        handle = attach_live_bridge(serving, sim, peer=0)
        obs = StepObserver.attach(sim)
        view = handle.view()
        with wall_window("warm", secs):
            warmed = sim.warm_apply_buckets(1 << 16)
        wait_for(lambda: serving.network.peers and writer.network.peers, "the peers' handshake")
        w = SERVING_WRITES
        start = time.perf_counter()
        for i in range(w):
            writer.get(f"cat/item{i:05d}").put(
                {"price": float(i % 1000), "tier": "gold" if i % 4 == 0 else "std"})
        wait_for(lambda: len(serving.store.get("cat", {})) == w, "the flood")
        wire = w / (time.perf_counter() - start)
        backlog = handle.backlog()
        gold = (w + 3) // 4
        start = time.perf_counter()
        got = view.count("cat", "tier", "gold")
        lag = time.perf_counter() - start
        if got != gold:
            raise AssertionError(f"phase 12: the mirror counts {got} gold, want {gold}")
        prices = {k: v["price"] for k, v in serving.store["cat"].items()}
        if view.range("cat", "price", 100.0, 200.0) != price_scan(prices, 100.0, 200.0):
            raise AssertionError("phase 12: the mirror's range differs from the store's scan")
        idle = {"equals": [], "range": [], "count": []}
        for _ in range(SERVING_ROUNDS):
            for name, call in (("equals", lambda: view.equals("cat", "tier", "gold")),
                               ("range", lambda: view.range("cat", "price", 100.0, 200.0)),
                               ("count", lambda: view.count("cat", "tier", "std"))):
                start = time.perf_counter()
                call()
                idle[name].append(time.perf_counter() - start)

        stop, wrote, top = threading.Event(), [0], dict(prices)
        rate = LOADED_PACE * wire

        def flood():
            i, begun = 0, time.perf_counter()
            while not stop.is_set():
                ahead = i - rate * (time.perf_counter() - begun)
                if ahead > 0:
                    time.sleep(ahead / rate)
                key, price = f"item{i % w:05d}", float((i * 7) % 1000)
                writer.get(f"cat/{key}/price").put(price)
                top[key] = max(top[key], price)
                wrote[0] = i = i + 1

        thread = threading.Thread(target=flood, name="phase12-writer", daemon=True)
        thread.start()
        loaded = []
        try:
            for _ in range(SERVING_ROUNDS):
                start = time.perf_counter()
                got = view.count("cat", "tier", "gold")
                loaded.append(time.perf_counter() - start)
                if got != gold:
                    raise AssertionError(f"phase 12: {got} gold under load, want {gold}")
        finally:
            stop.set()
            thread.join(timeout=10)
        if thread.is_alive():
            raise TimeoutError("phase 12: the writer thread did not stop")
        if not (writer.network.peers and serving.network.peers):
            raise AssertionError("phase 12: the db dropped the writer's link under the load")
        wait_for(lambda: serving.store["cat"] == writer.store["cat"],
                 "the serving store catching up with the writer")
        if view.count("cat", "tier", "gold") != gold:
            raise AssertionError("phase 12: the gold count after the load")
        # the mirror keeps each price's maximum (reference mode's value
        # order), the db its last write: each against its own scan
        if view.range("cat", "price", 100.0, 200.0) != price_scan(top, 100.0, 200.0):
            raise AssertionError("phase 12: the mirror's range after the load")
        store_prices = {k: v["price"] for k, v in serving.store["cat"].items()}
        last = {f"item{j % w:05d}": float((j * 7) % 1000) for j in range(wrote[0])}
        if store_prices != {**prices, **last}:
            raise AssertionError("phase 12: the serving store's prices after the load")
        with wall_window("flush", secs):
            flushed = handle.flush()
        if not (sim.tables_equal() and sim.converged()):
            raise AssertionError("phase 12: the mirror did not converge on flush()")
        for q in (p // 2, p - 1):
            if sim.get(q, "cat/item00004") != serving.store["cat"]["item00004"] | {
                    "price": top["item00004"]}:
                raise AssertionError(f"phase 12: peer {q} after flush()")
        idle_ms = {k: percentiles(v, (50, 95)) for k, v in idle.items()}
        loaded_ms = percentiles(loaded)
        log(f"  (a) warm_apply_buckets(2^16): {warmed} buckets in {secs['warm']:.3f} s; "
            f"{w} records over TCP at {wire:.0f} writes/s, backlog {backlog} at the first "
            f"query; mirror lag (the first count, {gold} gold) {1e3 * lag:.1f} ms")
        log("  (a) idle ms p50 / p95: " + "; ".join(
            f"{k} {v[50]:.3f} / {v[95]:.3f}" for k, v in idle_ms.items()))
        log(f"  (a) loaded count ms p50 / p95 / p99: {loaded_ms[50]:.3f} / {loaded_ms[95]:.3f}"
            f" / {loaded_ms[99]:.3f} (the reference's bound on p95: "
            f"{SERVING_P95_BOUND_MS:.0f} ms, not asserted) under {wrote[0]} price overwrites "
            f"paced at {rate:.0f}/s ({wrote[0] / sum(loaded):.0f}/s of query time); flush() "
            f"{flushed} rounds in {secs['flush']:.3f} s, tables_equal; {card}")

        bridge_and_serializer(serving, p, dev)

        for i in range(16):  # (d): writes for one traced converge
            serving.get(f"cat/late{i}").put({"price": 1000.0 + i, "tier": "gold"})
        trace_dir = f"{PHASE12_DIR}/trace"
        shutil.rmtree(trace_dir, ignore_errors=True)
        with profile_trace(trace_dir):
            traced = handle.flush()
        kernels = trace_kernels(trace_dir)
        shutil.rmtree(trace_dir, ignore_errors=True)
        if not kernels:
            raise AssertionError("phase 12: the trace holds no kernel of the port")
        summary = obs.summary()
        log(f"  (d) profile_trace around flush() ({traced} rounds): {sum(kernels.values())} "
            f"events of the port's kernels {dict(kernels)}")
        log(f"  (d) StepObserver: {summary['events']} events, {summary['steps']} steps, "
            f"{summary['total_wall_s']:.3f} s, last residual {summary['last_residual']}, "
            f"stats {summary['stats']}")
        obs.detach()
    finally:
        if handle is not None:
            handle.detach()
        for b in (writer, serving):
            if b is not None:
                b.close()


def trace_kernels(trace_dir: str) -> Counter:
    """The port's kernel events in the Chrome traces under ``trace_dir``,
    counted by kernel."""
    import glob

    found: Counter = Counter()
    for path in glob.glob(f"{trace_dir}/trace_*.json"):
        with open(path) as f:
            for event in json.load(f).get("traceEvents", []):
                if event.get("cat") != "kernel":
                    continue
                name = str(event.get("name", ""))
                for kernel in PORT_KERNEL_NAMES:
                    if kernel in name:
                        found[kernel] += 1
    return found


def bridge_and_serializer(serving, p: int, dev) -> None:
    """Phase 12 (c): a dense sim from the serving store, dumped at its last
    peer into a fresh Bullet; its export; the serving store's CSV and XML
    imported into a rank1 sim; each against the serving Bullet."""
    from bullet_tpu_torch import PeerNetworkSim, create
    from bullet_tpu_torch.models.bridge import dump_sim_into_bullet, sim_from_bullet

    secs: dict = {}
    with wall_window("sim_from_bullet", secs):
        mirror = sim_from_bullet(serving, p, device=dev)
    fresh, scratch = (create({"storage": False, "disable_network": True}) for _ in range(2))
    try:
        with wall_window("dump", secs):
            dumped = dump_sim_into_bullet(mirror, fresh, peer=p - 1)
        if fresh.store != serving.store:
            raise AssertionError("phase 12: the dump differs from the serving store")
        exported = json.loads(mirror.export_to_json(p - 1, "cat"))["data"]
        if exported != json.loads(serving.export_to_json("cat"))["data"]:
            raise AssertionError("phase 12: the sim's export differs from the serving Bullet's")
        csv, xml = serving.export_to_csv("cat"), serving.export_to_xml("cat")
        imported = PeerNetworkSim(p, capacity=1 << 15, topology="ring", layout="rank1",
                                  device=dev)
        with wall_window("import", secs):
            results = [imported.import_from_csv(0, csv, "csv"),
                       imported.import_from_xml(p // 2, xml, "xml")]
            rounds = imported.run_until_converged()
        scratch.import_from_csv(csv, "csv")
        scratch.import_from_xml(xml, "xml")
        for target in ("csv", "xml"):
            if imported.get(p - 1, target) != scratch.get(target).value():
                raise AssertionError(f"phase 12: the {target} import reads back otherwise")
        if not all(r["success"] for r in results) or not imported.tables_equal():
            raise AssertionError(f"phase 12: the imports {results}")
    finally:
        fresh.close()
        scratch.close()
    log(f"  (c) sim_from_bullet: dense {p} x {mirror.capacity} in "
        f"{secs['sim_from_bullet']:.2f} s; {dumped} leaves dumped at peer {p - 1} in "
        f"{secs['dump']:.2f} s, store equal; export_to_json equal; CSV and XML imported "
        f"into rank1 {p} x {imported.capacity}, converged in {rounds} rounds "
        f"({secs['import']:.2f} s), read back equal")


def rank1_vids(sim) -> torch.Tensor:
    """A rank1 sim's [P, N] value ids (-1 where absent), decoded on the
    device through its own RankIndex."""
    from bullet_tpu_torch.ops.rank import decode_vids_rank1

    sim._sync_rank_index()
    sr, sv = (torch.from_numpy(a).to(sim.device) for a in sim.rank_index.inverse_arrays())
    present, vid = decode_vids_rank1(sim.table.rank, sr, sv)
    return torch.where(present, vid, -1)


def same_state(a, b) -> bool:
    """Two sims hold the same entries: their tables bit-equal, except on
    rank1, whose ranks are each sim's own RankIndex's (a load re-spreads
    them, as the reference's does), where the decoded value ids are."""
    if a.layout == "rank1":
        return torch.equal(rank1_vids(a), rank1_vids(b))
    return tables_same(a, b)


def checkpoint_round_trips(args, dev, card: str) -> None:
    """Phase 12 (b): packed and rank1 P x 2^16 rings (phase 10's records cut
    to a sixteenth), converged, saved, loaded on the card: tables bit-equal,
    sampled gets equal, and the loaded sim given a second batch converges to
    the saved sim's table given the same batch; the packed checkpoint also
    loaded onto a 4-shard mesh against the unsharded load."""
    from bullet_tpu_torch import PeerNetworkSim

    p, n = args.peers, CHECKPOINT_CAPACITY
    for layout in ("packed", "rank1"):
        rng = np.random.default_rng(args.seed + 120)
        secs: dict = {}
        sim = PeerNetworkSim(p, capacity=n, topology="ring", layout=layout, device=dev)
        for batch in query_batches(rng, p, n):
            sim.put_bulk(*batch)
        sim.run_until_converged()
        directory = f"{PHASE12_DIR}/{layout}"
        shutil.rmtree(directory, ignore_errors=True)
        with wall_window("save", secs):
            sim.save_checkpoint(directory)
        on_disk = sum(os.path.getsize(f"{directory}/{f}") for f in os.listdir(directory))
        with wall_window("load", secs):
            loaded = PeerNetworkSim.load_checkpoint(directory, device=dev)
        if not same_state(loaded, sim):
            raise AssertionError(f"phase 12 (b) {layout}: the loaded table differs")
        raw = tables_same(loaded, sim)
        paths = [sim.host.paths.path(int(i))
                 for i in rng.integers(0, len(sim.host.paths), 256)]
        for q in (0, p - 1):
            peers = np.full(len(paths), q, dtype=np.int32)
            if loaded.get_bulk(peers, paths) != sim.get_bulk(peers, paths):
                raise AssertionError(f"phase 12 (b) {layout}: reads at peer {q}")
        mesh_note = ""
        if layout == "packed":
            with wall_window("mesh load", secs):
                mesh = PeerNetworkSim.load_checkpoint(directory, [dev] * SHARDS, device=dev)
            if not tables_same(mesh, loaded):
                raise AssertionError("phase 12 (b): the mesh load differs from the unsharded")
            mesh_note = f", on {SHARDS} shards {secs['mesh load']:.2f} s, equal"
            del mesh
        second = query_batches(np.random.default_rng(args.seed + 121), p, n)
        rounds = []
        for s in (sim, loaded):
            for batch in second:
                s.put_bulk(*batch)
            rounds.append(s.run_until_converged())
        if not same_state(loaded, sim) or len(set(rounds)) != 1:
            raise AssertionError(f"phase 12 (b) {layout}: the second batch {rounds}")
        table_bytes = sum(f.numel() * f.element_size() for f in sim.table)
        log(f"  (b) {layout} {p} x {n}: save {secs['save']:.2f} s, load {secs['load']:.2f} s"
            f"{mesh_note}; {on_disk / 1e6:.1f} MB on disk for a {table_bytes / 1e6:.1f} MB "
            f"table ({table_bytes / secs['save'] / 1e9:.3f} GB/s saved, "
            f"{table_bytes / secs['load'] / 1e9:.3f} GB/s loaded); "
            f"{'value ids' if layout == 'rank1' else 'tables'} bit-equal (raw fields "
            f"{'equal' if raw else 'differ'}), reads equal, a second batch converged alike in "
            f"{rounds[0]} rounds; {card}")
        shutil.rmtree(directory, ignore_errors=True)
        del sim, loaded
        free(dev)


def serving_path(args, dev, card: str) -> dict:
    """Phase 12: the serving path. Returns its launches; raises if a check
    fails or a kernel it drives was never launched."""
    from bullet_tpu_torch import _build

    _build.reset_launches()
    serving_mirror(args, dev, card)
    free(dev)
    checkpoint_round_trips(args, dev, card)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    log(f"  launches (phase 12): {launches}")
    missing = [k for k in SERVING_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 12 never launched: {missing}")
    return launches


# ----------------------------------------------------------------- phase 13

# phase 13 (a): this many processes, each owning two of the mesh's four
# shards on the one card; gloo carries their exchanges (NCCL refuses two
# processes on one card)
MESH_PROCESSES = 2
# the kernels every process of phase 13 (a) must launch on its mesh sims:
# the packed sim's apply, ring step, column pass (its converge), windows
# (its cutoff), the folds and reconcile; rank1's spmd jump and its HALO_FUSE
# converge; the dense sim's per-shard frontier at m = 1 and 8
PROCESS_KERNELS = ("apply_packed", "frontier_shard packed", "column_summaries",
                   "settle_columns", "frontier_shard_window", "compact_counts window",
                   "compact_counts", "reconcile_packed", "window_shard",
                   "frontier_shard packed fused", "compact_counts fused", "frontier_shard",
                   "frontier_shard fused")
# and the one NCCL process of phase 13 (b): the packed sim's path
NCCL_KERNELS = ("apply_packed", "frontier_shard packed", "column_summaries", "settle_columns",
                "frontier_shard_window", "compact_counts window", "compact_counts",
                "reconcile_packed")
# the sizes a phase 13 process is given, as the script was
SIZE_ARGS = ("seed", "peers", "capacity", "ops", "packed_capacity", "packed_ops",
             "rank1_capacity", "rank1_ops", "lean_capacity", "lean_ops")
# what marks a phase 13 process's result line
RESULT_TAG = "phase 13 result: "
# a collective waits this long for the other process before it fails
PROCESS_TIMEOUT_S = 240.0
# and (a) and (b) this long before their processes are killed
PHASE13_DEADLINES_S = {"gloo": 480.0, "nccl": 240.0}


class ExchangeClock:
    """What a process's mesh exchanges cost, measured around
    ``parallel/shardmap_gossip.py``'s calls of the transport (patched in
    this process only): host seconds of the boundary transfers and of the
    sums (counts, the fold, the reconcile's rows), the bytes this process
    sent to and received from the other, and CUDA-event times of the
    per-shard kernels and folds (the card is shared with the other
    process, so these include its contention). The transfers' seconds
    split three ways: copying a message into pinned host memory
    (``mesh._wire``), waiting on the process group's sends and receives,
    and the rest (each slab's stack on the card, the received rows' copy
    back to it)."""

    TIMED_KERNELS = ("frontier_shard_round", "frontier_shard_round_packed",
                     "frontier_shard_window", "ring_window_shard_packed", "compact_counts",
                     "compact_counts_window", "column_summaries", "settle_columns")

    def __init__(self):
        from bullet_tpu_torch.parallel import shardmap_gossip as sg

        self.sg = sg
        self.saved = {}
        self.reset()
        clock = self

        def transfer(mesh, jobs, nf, n, copy=True):
            torch.cuda.synchronize()  # the exchange alone, not the kernels before it
            for src, dst, r, _ in jobs:
                if mesh.owners[src] != mesh.owners[dst]:
                    nbytes = 4 * nf * r * n
                    if mesh.owns(src):
                        clock.sent += nbytes
                    elif mesh.owns(dst):
                        clock.received += nbytes
            start = time.perf_counter()
            clock.in_transfer = True
            out = clock.saved["transfer"](mesh, jobs, nf, n, copy)
            clock.in_transfer = False
            clock.transfer_s += time.perf_counter() - start
            return out

        def summed(name):
            def run(mesh, *a, **kw):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = clock.saved[name](mesh, *a, **kw)
                clock.sum_s += time.perf_counter() - start
                return out
            return run

        def timed(name):
            def run(*a, **kw):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = clock.saved[name](*a, **kw)
                end.record()
                clock.events.append((start, end))
                return out
            return run

        patches = {"transfer": transfer, "all_sum": summed("all_sum"),
                   "disjoint_sum": summed("disjoint_sum")}
        patches.update({k: timed(k) for k in self.TIMED_KERNELS})
        for name, fn in patches.items():
            self.saved[name] = getattr(sg, name)
            setattr(sg, name, fn)

        from bullet_tpu_torch.parallel import mesh as mesh_module

        def wire(t):
            start = time.perf_counter()
            out = clock.saved["_wire"](t)
            if out is not t and clock.in_transfer:
                clock.stage_s += time.perf_counter() - start
            return out

        class Waited:
            def __init__(self, work):
                self.work = work

            def wait(self):
                start = time.perf_counter()
                self.work.wait()
                clock.wait_s += time.perf_counter() - start

        self.saved["_wire"] = mesh_module._wire
        mesh_module._wire = wire
        self.saved["batch"] = torch.distributed.batch_isend_irecv
        torch.distributed.batch_isend_irecv = lambda ops: [
            Waited(w) for w in self.saved["batch"](ops)]

    def reset(self):
        self.sent = self.received = 0
        self.transfer_s = self.sum_s = self.stage_s = self.wait_s = 0.0
        self.in_transfer = False
        self.events = []

    def read(self) -> dict:
        torch.cuda.synchronize()
        kernels_ms = sum(s.elapsed_time(e) for s, e in self.events)
        out = {"sent_bytes": self.sent, "received_bytes": self.received,
               "transfer_s": self.transfer_s, "sum_s": self.sum_s, "stage_s": self.stage_s,
               "wait_s": self.wait_s,
               "kernels_s": kernels_ms / 1e3, "kernel_calls": len(self.events)}
        self.reset()
        return out


def process_mesh_path(args, rank: int, world: int, backend: str, coordinator: str) -> dict:
    """One process of phase 13: joins the process group, builds the mesh
    (``SHARDS // world`` shards a process on its card: cuda:0 for both of
    phase 13's gloo processes and for the NCCL world of one, card ``rank``
    where there is one a process) and drives the mesh sims beside
    unsharded twins given the same ops, each process checking its own
    shards against its twin's rows. Logs each window's wall seconds and
    what the exchanges cost. Returns the values every process must agree
    on and the launches of the port's kernels on the mesh sims (the
    twins' apart)."""
    from bullet_tpu_torch import PeerNetworkSim, _build
    from bullet_tpu_torch.parallel.multihost import global_mesh, host_info, initialize_multihost
    from bullet_tpu_torch.parallel.shardmap_gossip import HALO_FUSE, gossip_frontier_shardmap_packed

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    initialize_multihost(coordinator, world, rank, backend=backend, timeout_s=PROCESS_TIMEOUT_S)
    _build.library()
    mesh = global_mesh([dev] * (SHARDS // world))
    info = host_info()
    log(f"  process {rank} of {world} ({backend}): {info}, shards {mesh.local} of {len(mesh)}")
    clock = ExchangeClock()
    secs: dict = {}
    values: dict = {}
    mesh_launches = Counter()
    tag = f"p{rank}/{world}"

    @contextlib.contextmanager
    def on_mesh(name):
        """A window of the mesh sim: wall seconds, its kernels' launches."""
        before = dict(_build.LAUNCHES)
        with wall_window(name, secs):
            yield
        mesh_launches.update({k: v - before[k] for k, v in _build.LAUNCHES.items()})

    def same(what, sim, twin, got, want):
        values[what] = got
        if got != want or not sharded_equal_local(sim.table, twin.table):
            raise AssertionError(f"phase 13 {tag} {what}: {got} against the twin's {want}")

    p, n = args.peers, args.packed_capacity
    n_leaf = n - 256
    rng = np.random.default_rng(args.seed + 13)

    def build(layout, sharded, capacity=n, mode="reference"):
        kw = dict(mesh_devices=mesh, use_shard_map=True) if sharded else {}
        return PeerNetworkSim(p, capacity=capacity, topology="ring", layout=layout, mode=mode,
                              device=dev, **kw)

    def load(sims, peers, leaves, vals, capacity=n):
        slots = {}
        for s in sims:
            slots[s] = s.host.intern_batch([f"k/{i}" for i in range(capacity - 256)])
            s.put_bulk(peers, slots[s][leaves], vals)
            s.put(5, "s/name", "alice")
            s.put(p - 1, "s/name", "bob")
            s.put(p // 2, "s/obj", {"a": 1, "b": "x"})
        return slots

    def exchange_line(what, steps):
        c = clock.read()
        per_step = c["sent_bytes"] / max(steps, 1)
        values[f"{what} steps"] = steps
        log(f"  {tag} {what}: {steps} mesh steps; sent {c['sent_bytes'] / 1e9:.3f} GB, received "
            f"{c['received_bytes'] / 1e9:.3f} GB ({per_step / 1e6:.1f} MB sent a step); "
            f"exchange {c['transfer_s']:.3f} s host (transfers: {c['stage_s']:.3f} into pinned "
            f"memory, {c['wait_s']:.3f} waiting on the sends and receives, the rest "
            f"{c['transfer_s'] - c['stage_s'] - c['wait_s']:.3f}) + {c['sum_s']:.3f} s (sums); "
            f"kernels {c['kernels_s']:.3f} s on CUDA events ({c['kernel_calls']} calls)")
        return c

    _build.reset_launches()
    # packed: step(1), the converge, a cutoff, converged(), reconcile, reads
    sim, twin = build("packed", True), build("packed", False)
    peers = rng.integers(0, p, args.packed_ops).astype(np.int32)
    leaves = rng.integers(0, n_leaf, args.packed_ops)
    vals = rng.integers(-500, 500, args.packed_ops)
    slots = load((sim, twin), peers, leaves, vals)
    routes = (sim._convergence_strategy()[0], twin._convergence_strategy()[0])
    if routes != ("packed-frontier-spmd", "packed-frontier-local"):
        raise AssertionError(f"phase 13 {tag} packed routes {routes}")
    clock.read()
    with on_mesh("packed step(1)"):
        r_sim = sim.step(1)
    r_twin = twin.step(1)
    same("packed step(1)", sim, twin, (r_sim, sim.stats["ops_applied"]),
         (r_twin, twin.stats["ops_applied"]))
    exchange_line("packed step(1)", 1)
    folds = mesh_launches["compact_counts window"] + mesh_launches["compact_counts"]
    with on_mesh("packed run_until_converged"):
        rounds = sim.run_until_converged()
    twin_rounds = twin.run_until_converged()
    same("packed converge", sim, twin, (rounds, sim.last_residual), (twin_rounds, 0))
    steps = mesh_launches["compact_counts window"] + mesh_launches["compact_counts"] - folds
    conv = exchange_line("packed converge", steps)
    values["packed converge bytes a step"] = conv["sent_bytes"] / max(steps, 1)
    n_written = check_leaf_values(sim, [(leaves, vals)], slots[sim], rng, f"phase 13 {tag}")
    more = 1 << 16
    leaves2 = rng.integers(0, min(n_leaf, 1 << 16), more)
    peers2, vals2 = rng.integers(0, p, more).astype(np.int32), rng.integers(-600, 600, more)
    for s in (sim, twin):
        s.put_bulk(peers2, slots[s][leaves2], vals2)
    folds = mesh_launches["compact_counts window"] + mesh_launches["compact_counts"]
    with on_mesh("packed cutoff converge"):
        cut = (sim.run_until_converged(max_rounds=70), sim.last_residual)
    same("packed cutoff", sim, twin, cut, (twin.run_until_converged(max_rounds=70),
                                           twin.last_residual))
    exchange_line("packed cutoff at 70",
                  mesh_launches["compact_counts window"] + mesh_launches["compact_counts"] - folds)
    with on_mesh("packed converged()"):
        done = sim.converged()
    same("packed converged()", sim, twin, done, twin.converged())
    for s in (sim, twin):
        s.put(7, "s/name", "carol")
    with on_mesh("packed reconcile"):
        sim.reconcile()
    twin.reconcile()
    same("packed reconcile", sim, twin, sim.tables_equal(), True)
    exchange_line("packed converged() and reconcile", 2)
    sample = [f"k/{i}" for i in rng.integers(0, n_leaf, 64)] + ["s/name", "nope"]
    read_peers = np.r_[rng.integers(0, p // 2, 33), rng.integers(p // 2, p, 33)]
    got = (sim.get_bulk(read_peers, sample), sim.get(3, "s"), sim.get(p - 3, "s"))
    same("packed reads", sim, twin, got, (twin.get_bulk(read_peers, sample), twin.get(3, "s"),
                                          twin.get(p - 3, "s")))
    if got[1]["name"] != "carol":
        raise AssertionError(f"phase 13 {tag}: late write lost")
    clock.read()
    log(f"  {tag} packed ({len(mesh)} shards of {p // len(mesh)} x {n}, {12 * p * n / 1e9:.1f} "
        f"GB, {len(mesh.local)} here, + the twin): step(1) residual {r_sim} in "
        f"{secs['packed step(1)']:.3f} s; run_until_converged [{routes[0]}] {rounds} rounds in "
        f"{secs['packed run_until_converged']:.3f} s; cutoff at 70: residual {cut[1]} in "
        f"{secs['packed cutoff converge']:.3f} s; converged() {done} in "
        f"{secs['packed converged()']:.3f} s; reconcile {secs['packed reconcile']:.3f} s; "
        f"every local field, rounds, residuals, applied counts and reads == the twin; "
        f"{n_written} leaves == numpy per-leaf max")
    del sim, twin
    free(dev)
    if world == 1:
        log(f"  {tag} windows (wall s): {secs}")
        return {"values": values, "launches": dict(mesh_launches), "secs": secs}

    # rank1: the spmd fast_forward(480) against step(480) on the twin, then
    # the HALO_FUSE converge against the twin's
    n1 = args.rank1_capacity
    sim, twin = build("rank1", True, n1), build("rank1", False, n1)
    peers = rng.integers(0, p, args.rank1_ops).astype(np.int32)
    leaves = rng.integers(0, n1 - 256, args.rank1_ops)
    vals = rng.integers(-500, 500, args.rank1_ops)
    load((sim, twin), peers, leaves, vals, n1)
    for s in (sim, twin):
        s.step(0)
    depth = min(480, p // 2 - 1)
    ff_route = sim._fast_forward_route()
    with on_mesh("rank1 fast_forward(k)"):
        r_ff = sim.fast_forward(depth)
    r_step = twin.step(depth)
    same(f"rank1 fast_forward({depth})", sim, twin, (ff_route, r_ff, sim.stats["ops_applied"]),
         ("spmd", r_step, twin.stats["ops_applied"]))
    exchange_line(f"rank1 fast_forward({depth})", -(-depth // sim.table.rows))
    twin_rounds = twin.run_until_converged()
    t_total = n1 // sim._frontier_tile()
    with on_mesh("rank1 fused converge"):
        _, fused_rounds, fused_last = gossip_frontier_shardmap_packed(
            sim.table, torch.ones(t_total, dtype=torch.bool, device=dev), True,
            2 * sim.topology.diameter + 2, fuse=HALO_FUSE, tile_n=sim._frontier_tile())
    same("rank1 fused converge", sim, twin, (fused_rounds, fused_last), (twin_rounds, 0))
    exchange_line("rank1 HALO_FUSE converge", -(-fused_rounds // HALO_FUSE))
    log(f"  {tag} rank1 ({4 * p * n1 / 1e9:.1f} GB): fast_forward({depth}) [{ff_route}] in "
        f"{secs['rank1 fast_forward(k)']:.3f} s == step({depth}) on the twin (residual {r_ff}); "
        f"gossip_frontier_shardmap_packed(fuse={HALO_FUSE}) {fused_rounds} rounds in "
        f"{secs['rank1 fused converge']:.3f} s == the twin's converge")
    del sim, twin
    free(dev)

    # dense lww at phase 8's shape: step(1), the HALO_FUSE converge, a cutoff
    nd = args.capacity
    sim = build("dense", True, nd, mode="lww")
    twin = build("dense", False, nd, mode="lww")
    peers = rng.integers(0, p, args.ops).astype(np.int32)
    leaves = rng.integers(0, nd - 256, args.ops)
    vals = rng.integers(-500, 500, args.ops)
    slots = load((sim, twin), peers, leaves, vals, nd)
    route = sim._convergence_strategy()[0]
    if route != "dense-frontier-spmd":
        raise AssertionError(f"phase 13 {tag} dense route {route}")
    with on_mesh("dense step(1)"):
        r_sim = sim.step(1)
    same("dense step(1)", sim, twin, (r_sim, sim.stats["ops_applied"]),
         (twin.step(1), twin.stats["ops_applied"]))
    clock.read()
    folds = mesh_launches["compact_counts fused"] + mesh_launches["compact_counts"]
    with on_mesh("dense run_until_converged"):
        rounds = sim.run_until_converged()
    same("dense converge", sim, twin, (rounds, sim.last_residual),
         (twin.run_until_converged(), 0))
    exchange_line("dense converge", mesh_launches["compact_counts fused"]
                  + mesh_launches["compact_counts"] - folds)
    more = max(1, args.ops // 16)
    leaves2, vals2 = rng.integers(0, nd - 256, more), rng.integers(-600, 600, more)
    peers2 = rng.integers(0, p, more).astype(np.int32)
    for s in (sim, twin):
        s.put_bulk(peers2, slots[s][leaves2], vals2)
    with on_mesh("dense cutoff converge"):
        cut = (sim.run_until_converged(max_rounds=12), sim.last_residual)
    same("dense cutoff", sim, twin, cut, (twin.run_until_converged(max_rounds=12),
                                          twin.last_residual))
    clock.read()
    log(f"  {tag} dense lww ({28 * p * nd / 1e9:.1f} GB): step(1) residual {r_sim} in "
        f"{secs['dense step(1)']:.3f} s; run_until_converged [{route}] {rounds} rounds in "
        f"{secs['dense run_until_converged']:.3f} s; cutoff at 12: residual {cut[1]}; every "
        "local field, rounds and residuals == the twin")
    del sim, twin
    free(dev)
    log(f"  {tag} windows (wall s): {secs}")
    return {"values": values, "launches": dict(mesh_launches), "secs": secs}


def sharded_equal_local(sharded, table) -> bool:
    """Every field of this process's shards equals the twin's rows."""
    b = sharded.rows
    return all(torch.equal(f, g[i * b:(i + 1) * b])
               for i, shard in sharded.local() for f, g in zip(shard, table))


def process_main(args) -> int:
    """A phase 13 process (``--mesh-process RANK``): its log on stdout, its
    result as JSON on the line that starts with RESULT_TAG."""
    import torch.distributed as dist

    out = process_mesh_path(args, args.mesh_process, args.mesh_world, args.mesh_backend,
                            args.coordinator)
    dist.destroy_process_group()
    print(RESULT_TAG + json.dumps(out, default=str), flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(args, world: int, backend: str, tmp: str) -> list:
    """Start ``world`` phase 13 processes of this script, join them (a
    process that fails kills the others; all are killed at the deadline),
    print their logs and return their results."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    forwarded = [f"--{k.replace('_', '-')}={getattr(args, k)}" for k in SIZE_ARGS]
    procs, outputs = [], []
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(open(os.path.join(tmp, f"process{world}_{rank}.log"), "w+"))
                for rank in range(world)]
        deadline = time.perf_counter() + PHASE13_DEADLINES_S[backend]
        try:
            for rank in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), *forwarded,
                     f"--mesh-process={rank}", f"--mesh-world={world}",
                     f"--mesh-backend={backend}", f"--coordinator={coordinator}"],
                    stdout=logs[rank], stderr=subprocess.STDOUT, env=env))
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.perf_counter() > deadline:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for f in logs:
            f.seek(0)
            outputs.append(f.read().splitlines())
    results = []
    for rank, (p, lines) in enumerate(zip(procs, outputs)):
        # the result is the process's JSON line; libraries may log after it
        result = next((line for line in reversed(lines) if line.startswith(RESULT_TAG)), None)
        for line in lines:
            if line is not result:
                log(f"  [{backend} {rank}] {line}")
        if p.returncode != 0 or result is None:
            raise AssertionError(f"phase 13: process {rank} of {world} ({backend}) ended with "
                                 f"{p.returncode}")
        results.append(json.loads(result[len(RESULT_TAG):]))
    return results


def check_processes(who: str, results: list, kernels) -> None:
    """Every process's values equal the first's, and each launched every
    kernel of ``kernels`` on its mesh sims."""
    for rank, r in enumerate(results):
        if r["values"] != results[0]["values"]:
            raise AssertionError(f"phase 13: {who} process {rank} disagrees with process 0: "
                                 f"{r['values']} against {results[0]['values']}")
        launches = {k: r["launches"].get(k, 0) for k in kernels}
        log(f"  launches on the mesh sims of {who} process {rank}: {launches}")
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"phase 13 {who} process {rank} never launched {missing}")


def processes_path(args, dev, card: str) -> dict:
    """Phase 13: (a) two processes under gloo, two shards of cuda:0 each,
    the packed, rank1 and dense mesh sims beside their twins; (b) one
    process under NCCL, a world of one with four shards on cuda:0, the
    packed path. Each process's mesh launches must reach every kernel of
    its path; the values of (a)'s two processes must agree. Returns (a)'s
    launches by process."""
    import tempfile

    free(dev)
    free_b, total_b = torch.cuda.mem_get_info()
    log(f"  card memory free before the processes: {free_b / 1e9:.1f} of {total_b / 1e9:.1f} GB "
        f"(this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB); {card}")
    with tempfile.TemporaryDirectory() as tmp:
        started = time.perf_counter()
        gloo = run_processes(args, MESH_PROCESSES, "gloo", tmp)
        t_gloo = time.perf_counter() - started
        started = time.perf_counter()
        nccl = run_processes(args, 1, "nccl", tmp)
        t_nccl = time.perf_counter() - started
    check_processes("gloo", gloo, PROCESS_KERNELS)
    check_processes("nccl", nccl, NCCL_KERNELS)
    log(f"  (a) {MESH_PROCESSES} gloo processes in {t_gloo:.1f} s, values equal in both; "
        f"(b) one NCCL process in {t_nccl:.1f} s; {card}")
    return {rank: r["launches"] for rank, r in enumerate(gloo)}


def bridge_main_path(args, dev, window=wall_window) -> dict:
    """Phase 14. Returns the phase's launches."""
    from bullet_tpu_torch import PeerNetworkSim, _build
    from bullet_tpu_torch.ops import packed as pk

    p, n = args.peers, args.packed_capacity
    secs: dict = {}
    rng = np.random.default_rng(args.seed + 14)
    sim = PeerNetworkSim(p, capacity=n, topology=BRIDGE_SPEC, layout="packed", device=dev,
                         use_kernels=True)
    n_leaf = n - 256
    slot_of_leaf = sim.host.intern_batch([f"k/{i}" for i in range(n_leaf)])
    batches = []
    plain_rounds = []
    real_round = pk.gossip_round_generic_packed

    def counted(*a, **kw):
        plain_rounds.append(1)
        return real_round(*a, **kw)

    pk.gossip_round_generic_packed = counted

    def batch(k, leaves):
        peers = rng.integers(0, p, k).astype(np.int32)
        leaf = rng.integers(0, leaves, k)
        vals = rng.integers(-500, 500, k)
        batches.append((leaf, vals))
        return peers, slot_of_leaf[leaf], vals

    def converge(name, max_rounds=None):
        before = _build.LAUNCHES["converge_graph"]
        with window(name, secs):
            rounds = sim.run_until_converged(max_rounds)
        if _build.LAUNCHES["converge_graph"] != before + 1:
            raise AssertionError(f"bridge {name}: not one launch of the graph pass")
        return rounds

    try:
        _build.reset_launches()
        sim.put_bulk(*batch(args.packed_ops, n_leaf))
        sim.step(0)
        rounds = converge("bridge converge")
        if sim.last_residual != 0 or not sim.tables_equal():
            raise AssertionError("bridge converge did not reach the fixed point")
        written = check_leaf_values(sim, batches, slot_of_leaf, rng, "bridge converge")
        log(f"  put_bulk {args.packed_ops} ops, step(0), run_until_converged "
            f"[{sim._convergence_strategy()[0]}] through the graph pass: {rounds} rounds in "
            f"{secs['bridge converge']:.3f} s; == numpy per-leaf max over {written} leaves")
        sim.put_bulk(*batch(65536, n_leaf))
        sim.step(0)
        cols = sim._marks.columns()
        rounds = converge("bridge incremental converge")
        check_leaf_values(sim, batches, slot_of_leaf, rng, "bridge incremental")
        log(f"  put_bulk 65536 ops + run_until_converged: {rounds} rounds in "
            f"{secs['bridge incremental converge']:.3f} s on "
            f"{'every' if cols is None else int(cols.sum())} dirty columns")
        sim.put_bulk(*batch(65536, n_leaf))
        sim.step(0)
        capped = converge("bridge capped converge", 2)
        left = sim.last_residual
        converge("bridge converge after the cap")
        check_leaf_values(sim, batches, slot_of_leaf, rng, "bridge capped")
        sim.put_bulk(*batch(65536, n_leaf))
        residual = sim.step(2)
        merged = sim.stats["merged_entries"]
        converge("bridge converge after step(2)")
        check_leaf_values(sim, batches, slot_of_leaf, rng, "bridge step(2)")
        if plain_rounds:
            raise AssertionError(f"bridge: {len(plain_rounds)} plain rounds ran")
        # converged() runs the plain round on a copy of the table
        if sim.last_residual != 0 or not sim.converged():
            raise AssertionError("bridge: not at the fixed point after step(2) and a converge")
        log(f"  capped at 2 rounds: {capped} rounds, residual {left}, then finished; step(2): "
            f"residual {residual}, merged entries {merged}; converged() True")
    finally:
        pk.gossip_round_generic_packed = real_round
    return dict(_build.LAUNCHES)


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
    ap.add_argument("--lean-capacity", type=int, default=1 << 20)
    ap.add_argument("--lean-ops", type=int, default=1 << 20)
    # a phase 13 process, started by the script itself
    ap.add_argument("--mesh-process", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=MESH_PROCESSES, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    return ap


def main() -> int:
    args = build_parser().parse_args()
    if args.mesh_process is not None:
        return process_main(args)
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
                      check_frontier_packed, check_converge_columns, check_window):
            check(dev, packed_shape, errs, times, nf)
            torch.cuda.empty_cache()
    check_small_sims(dev)
    check_small_packed_sims(dev)
    torch.cuda.empty_cache()
    from bullet_tpu_torch.ops.ring_kernel import frontier_tile_n

    lean_shape = (args.peers, args.lean_capacity)
    for check, shape in ((check_ring_lean, lean_shape), (check_frontier_lean, lean_shape),
                         (check_merge_lean, lean_shape),
                         (check_frontier_shard, (args.peers // SHARDS, args.capacity))):
        check(dev, shape, errs, times)
        torch.cuda.empty_cache()
    # the card's launch floor: an empty kernel (a spin of zero cycles), timed
    # as device_once times a call
    floor = device_once(lambda: torch.cuda._sleep(0))[1]
    check_compact_counts(dev, args.capacity // frontier_tile_n(args.capacity), errs, times, floor)
    check_small_lean_and_sharded_sims(dev)
    torch.cuda.empty_cache()
    # the packed family's per-shard kernels at every field count, on one
    # shard of phase 9's mesh
    for nf in (3, 2, 1):
        check_frontier_shard_packed(dev, (args.peers // SHARDS, args.packed_capacity), errs,
                                    times, nf)
        torch.cuda.empty_cache()
    check_compact_counts_window(dev, args.packed_capacity // frontier_tile_n(args.packed_capacity),
                                errs, times, floor)
    for nf in (3, 2, 1):
        check_window_shard(dev, (args.peers // SHARDS, args.packed_capacity), errs, times, nf)
        torch.cuda.empty_cache()
    for nf in (3, 2, 1):
        check_columns_shard(dev, packed_shape, errs, times, nf)
    check_small_packed_mesh_sims(dev)
    torch.cuda.empty_cache()

    for nf in (3, 2, 1):
        check_converge_graph(dev, packed_shape, errs, times, nf)
        torch.cuda.empty_cache()

    log(f"phase 4: dense main path, ring {args.peers} x {args.capacity}")
    launches = main_path(args, dev)
    free(dev)  # a sim holds reference cycles: collect it before the next phase
    log(f"phase 5: packed main path, ring {args.peers} x {args.packed_capacity}")
    launches.update(packed_main_path(args, dev))
    free(dev)
    log(f"phase 6: rank1 main path, ring {args.peers} x {args.rank1_capacity}")
    rank1_launches, _ = rank1_main_path(args, dev, card=smi)
    free(dev)
    log(f"phase 7: lean main path, ring {args.peers} x {args.lean_capacity}")
    lean_launches = lean_main_path(args, dev)
    free(dev)
    log(f"phase 8: sharded dense path, {SHARDS} shards on one card, ring "
        f"{args.peers} x {args.capacity}")
    shard_launches = sharded_main_path(args, dev)
    free(dev)
    log(f"phase 9: the packed family on a mesh, {SHARDS} shards on one card, ring "
        f"{args.peers} x {args.packed_capacity}")
    mesh_packed, mesh_rank1, _ = sharded_packed_path(args, dev, card=smi)
    free(dev)
    log(f"phase 10: queries on packed and rank1 {args.peers} x {args.packed_capacity}, dense "
        f"{args.peers} x {args.capacity} and a {SHARDS}-shard packed mesh, {smi}")
    query_path(args, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11: batch ingress on packed and rank1 {args.peers} x {args.packed_capacity}, "
        f"dense {args.peers} x {args.capacity} and a {SHARDS}-shard rank1 mesh, {smi}")
    ingress_path(args, dev, smi)
    free(dev)
    log(f"phase 12: the serving path, a live mirror on rank1 {args.peers} x "
        f"{args.rank1_capacity} over TCP on localhost, checkpoints, the bridge, the "
        f"serializer, the observer and a trace, {smi}")
    serving_path(args, dev, smi)
    log(f"phase 13: the mesh across processes, {MESH_PROCESSES} gloo processes of "
        f"{SHARDS // MESH_PROCESSES} shards each on the one card, then one NCCL process of "
        f"{SHARDS}, ring {args.peers} x {args.packed_capacity}, {smi}")
    processes_path(args, dev, smi)
    free(dev)
    log(f"phase 14: the bridge deployment, packed {args.peers} x {args.packed_capacity}, {smi}")
    launches["converge_graph"] = bridge_main_path(args, dev)["converge_graph"]

    # one row per kernel at the layout its main path drives (dense: phase
    # 4, packed: phase 5), one per packed-family kernel at rank1 (phase 6),
    # the lean kernels (phase 7; the merge and the dense frontier at
    # nf = 4), the sharded ones (phase 8, and the fused per-shard frontier
    # at nf = 4 with its lean run's launches) and the packed family's mesh
    # kernels at packed and rank1 (phase 9; its packed sim never takes the
    # fused frontier or the spmd window, the rank1 copy and jump do); the
    # rank (nf = 2) times, the packed frontier's m = 1 times, the window's
    # at m = 480 and the mesh's fused frontier and window at nf = 3 are in
    # the log above
    rows = [(name, name, launches[name])
            for name in (*DENSE_KERNELS, *PACKED_KERNELS, FUSED_ROUNDS, "converge_graph")]
    rows += [(tag(name, 1), name, rank1_launches[name]) for name in PACKED_KERNELS]
    rows += [("ring_round_lean", "ring_round_lean", lean_launches["ring_round_lean"]),
             ("frontier_round_dense lean", "frontier_round_dense",
              lean_launches["frontier_round_dense"]),
             ("merge lean", "merge", lean_launches["merge"])]
    rows += [(name, name, shard_launches[name]) for name in SHARD_KERNELS]
    rows.append(("frontier_shard fused lean", "frontier_shard fused",
                 shard_launches["frontier_shard fused lean"]))
    rows += [(name, name, mesh_packed[name]) for name in MESH_PACKED_KERNELS
             if name not in ("frontier_shard packed fused", "window_shard")]
    rows += [(tag(name, 1), name, mesh_rank1[name]) for name in MESH_PACKED_KERNELS]
    kernels = []
    for row, name, count in rows:
        src, rep = KERNELS[name]
        # a row's library call, where it has one, and keys of its own (what
        # the call computes, times on another clock)
        ms, plain_ms, (bound_ms, bound_by), *more = times[row]
        library, extra = (*more, None, {})[:2]
        kernels.append({
            "name": row, "route": "cuda", "source": src, "replaces": rep,
            "launches": count, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # only the rank1 rows have one PyTorch call that computes the
            # same table: the reconcile's column amax and broadcast copy, the
            # apply's scatter_reduce_ (without the count); no single call
            # computes the lexicographic multi-key selects
            "library_ms": library,
            **extra,
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
