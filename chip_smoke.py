#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (bullet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--peers P] [--capacity N] [--ops K]

Phases, in order; any failure raises and exits nonzero:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the kernels of bullet_tpu_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, bit-identical (tolerance: exact, the path is all int32), at
   small and ragged shapes and at the main-path shape, with times per call;
   then a small sim on the card against the same sim on the CPU;
4. main path: a dense ring PeerNetworkSim at P x N (default 1024 x 2^18):
   put_bulk + scalar puts, step, run_until_converged, tables_equal, the
   converged row against an independent numpy lexmax, get/get_bulk, more
   writes applied by step(0), reconcile against a twin restored from a
   snapshot that converges; every kernel's launch count over this phase
   must be > 0.

The last two lines are a JSON object describing the kernels and the
contract line {"ok": true, "device": {...}}. Imports nothing of JAX.
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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def random_table(seed: int, p: int, n: int, device, base_n: int = 4096):
    """A table with many ties: small value ranges, negative khi/klo, and
    cls=0 entries whose other fields are nonzero. Made from a numpy seed
    at [p, min(n, base_n)]; a wider table repeats that block along the slot
    axis on the device with its rows rotated by the block's index, so that
    blocks fewer than p apart hold different columns and a kernel that
    addresses the wrong block cannot match its plain version."""
    from bullet_tpu_torch.ops.merge import TableState

    rng = np.random.default_rng(seed)
    w = min(n, base_n)
    reps = -(-n // w)
    ranges = ((0, 4), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 4), (0, 5))
    fields = []
    for lo, hi in ranges:
        a = torch.from_numpy(rng.integers(lo, hi, (p, w), dtype=np.int32)).to(device)
        out = torch.empty((p, reps * w), dtype=torch.int32, device=device)
        for r in range(reps):
            out[:, r * w:(r + 1) * w] = torch.roll(a, r, 0)
        fields.append(out[:, :n].contiguous())
    return TableState(*fields)


def clone(table):
    return type(table)(*(f.clone() for f in table))


def max_err(a, b) -> int:
    """Largest |a - b| over tables (or tensors), as a Python int."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(
        int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


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
        frontier_tile_n_dense,
    )

    rng = np.random.default_rng(7)
    for p, n in ((1, 64), (3, 96), (64, 2048), (1000, 512)):
        tile = frontier_tile_n_dense(n)
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
    tile = frontier_tile_n_dense(n)
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
    launches = dict(_build.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    return launches


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--ops", type=int, default=1 << 20)
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
    errs = {k: 0 for k in KERNELS}
    times = {}
    check_merge(dev, main_shape, errs, times)
    torch.cuda.empty_cache()
    check_ring(dev, main_shape, errs, times)
    torch.cuda.empty_cache()
    check_frontier(dev, main_shape, errs, times)
    torch.cuda.empty_cache()
    check_small_sims(dev)
    torch.cuda.empty_cache()

    log(f"phase 4: main path, dense ring {args.peers} x {args.capacity}")
    launches = main_path(args, dev)

    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": times[name][0], "plain_ms": times[name][1],
        }
        for name, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
