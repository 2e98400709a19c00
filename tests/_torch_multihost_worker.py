"""Worker of tests/test_torch_multihost.py: one OS process of a two-process
gloo world, two CPU shards each, so that every mesh has four shards as in
tests/_multihost_worker.py (which stays the reference's own worker).

    python tests/_torch_multihost_worker.py COORDINATOR RANK CASES.npz OUT_DIR [MODE]

The pytest process computes the reference's side (JAX) on seeded numpy
inputs and writes them, with the expected results, to CASES.npz and
CASES.json; this worker imports torch and the port only. It runs

* the six families of tests/_multihost_worker.py through the port's
  sharded functions over the process mesh, and the column pass that an
  uncapped mesh converge takes on the card: each local shard against the
  reference's unsharded result, bit for bit, with its counts;
* the seeded op sequences of ``CELLS`` (``ops_for``, shared with the
  pytest process) on port sims over the process mesh: after every op the
  return value, ``last_residual`` and the local shards' rows against the
  reference's sim on four devices of one process;
* the module's own checks: ``host_info``, ``is_multihost`` and a second
  ``initialize_multihost``.

and writes ``rank<R>.json``: every case's verdict ("ok" or what
differed). MODE "die" makes rank 1 exit before the first collective, and
MODE "stall" makes it wait without calling it, so that rank 0's must
fail: at once, or within the process group's timeout."""

from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np

P, N = 64, 256  # the sims: 4 shards of 16 rows
SHARDS, PER_PROCESS = 4, 2
TIMEOUT_S = 30.0
# the "stall" mode's timeout: a process that waits this long on its peer
# gives up
STALL_TIMEOUT_S = 5.0

# (name, layout, mode, topology, use_shard_map, fused): fused cells force
# PeerNetworkSim._card_routes, so that HALO_FUSE (dense) and the m-row
# windows (packed, m = 15 at 16 rows a shard) cross the process boundary;
# the last cells take the other exchanges across it: a full mesh's
# doubling, a star's hub reduce, a bridge's gathers and weak reconcile
CELLS = tuple(
    (f"{layout}-{topology}-{'spmd' if spmd else 'data'}", layout,
     "lww" if layout == "dense" else "reference", topology, spmd, False)
    for layout in ("dense", "packed", "rank", "rank1")
    for topology in ("ring", "chain")
    for spmd in (True, False)
) + (
    ("packed-ring-spmd-fused", "packed", "reference", "ring", True, True),
    ("dense-ring-spmd-fused", "dense", "lww", "ring", True, True),
    ("dense-mesh-spmd", "dense", "lww", "mesh", True, False),
    ("packed-star-spmd", "packed", "reference", "star", True, False),
    ("rank1-bridge-data", "rank1", "reference", "bridge", False, False),
)

# the rank layouts' rank space, shrunk on both sides so that respreads
# happen within an op sequence
RANK_SPAN = 2047


def _value(rng, i, leaf=False):
    """A value of the kinds the sims store: numbers with ties, strings,
    quarters, and (unless ``leaf``) an object."""
    kind = int(rng.integers(4 if leaf else 5))
    if kind < 2:
        return int(rng.integers(-9, 9))
    if kind == 2:
        return "s" + "abc"[int(rng.integers(3))] * int(rng.integers(1, 4))
    if kind == 3:
        return float(rng.integers(-8, 8)) / 4
    return {"a": int(rng.integers(9)), "b": {"c": f"v{i % 3}"}}


def ops_for(cell: str, seed: int = 0):
    """The op sequence of a cell, as (name, args): the same on the
    reference's sim and on every process's port sim. Peers 0-31 live in
    process 0, 32-63 in process 1."""
    rng = np.random.default_rng(seed + sum(map(ord, cell)))
    ops = []
    k = 200
    ops.append(("put_bulk", (rng.integers(0, P, k).astype(np.int32),
                             [f"b/{int(x)}" for x in rng.integers(0, 90, k)],
                             rng.integers(-50, 50, k))))
    ops.append(("put", (3, "s/name", "alice")))
    ops.append(("put", (P - 5, "s/obj", {"a": 1, "b": "x"})))
    ops.append(("step", (1,)))
    ops.append(("put_bulk", (rng.integers(0, P, 40).astype(np.int32),
                             [f"t/{int(x)}" for x in rng.integers(0, 20, 40)],
                             [_value(rng, i, leaf=True) for i in range(40)])))
    ops.append(("fast_forward", (5,)))
    ops.append(("converged", ()))
    ops.append(("run_until_converged", (3,)))
    ops.append(("run_until_converged", ()))
    ops.append(("converged", ()))
    for i in range(6):
        ops.append(("put", (int(rng.integers(P)), f"t/{int(rng.integers(20))}", _value(rng, i))))
    ops.append(("step", (2,)))
    ops.append(("put_bulk", (rng.integers(0, P, 60).astype(np.int32),
                             [f"b/{int(x)}" for x in rng.integers(0, 90, 60)],
                             rng.integers(-80, 80, 60))))
    ops.append(("fast_forward", (40,)))
    ops.append(("put", (40, "s/name", "bob")))
    ops.append(("reconcile", ()))
    ops.append(("get", (7, "s")))
    ops.append(("get", (50, "")))
    ops.append(("get_bulk", ([1, 33, 62, 20], ["s/name", "b/3", "t/1", "nope"])))
    ops.append(("count", (45, "b", 3)))
    ops.append(("put", (12, "s/name", "carol")))
    ops.append(("run_until_converged", ()))
    ops.append(("converged", ()))
    return ops


def plain(x):
    """A return value as the JSON comparison sees it."""
    return json.loads(json.dumps(x))


# ------------------------------------------------------------------ worker


def _check_local(table, want, what, bad):
    """Every local shard's fields against the rows of the whole ``want``."""
    b = table.rows
    for i, shard in table.local():
        for f, (got, exp) in enumerate(zip(shard, want)):
            if not np.array_equal(got.numpy(), np.asarray(exp)[i * b:(i + 1) * b]):
                bad.append(f"{what}: shard {i} field {f}")


def families(cases, mesh, results):
    """The six families of tests/_multihost_worker.py through the port, and
    the column pass against the reference's frontier."""
    import torch

    from bullet_tpu_torch.convert import TABLE_TYPES
    from bullet_tpu_torch.parallel.mesh import shard_fields
    from bullet_tpu_torch.parallel.shardmap_gossip import (
        HALO_FUSE,
        gossip_columns_shardmap_packed,
        gossip_frontier_shardmap_dense,
        gossip_frontier_shardmap_packed,
        reconcile_shardmap_packed,
        ring_round_shardmap,
        ring_window_shardmap_packed,
    )

    def table(key, layout):
        return shard_fields(list(cases[key]), mesh, TABLE_TYPES[layout])

    def run(name, fn):
        bad = []
        try:
            fn(bad)
        except AssertionError as e:
            bad.append(str(e))
        results[name] = "ok" if not bad else "; ".join(bad)

    def dense_round(bad):
        t = table("dense8", "dense")
        t, changed = ring_round_shardmap(t, mode="reference")
        if int(changed) != int(cases["dense8_changed"]):
            bad.append(f"changed {int(changed)} != {int(cases['dense8_changed'])}")
        _check_local(t, cases["dense8_out"], "ring_round_shardmap", bad)

    def frontier(key, layout, **kw):
        def go(bad):
            from bullet_tpu_torch.ops.packed import frontier_tile_n

            t = table(key, layout)
            dirty = torch.ones(t.shape[1] // frontier_tile_n(t.shape[1]), dtype=torch.bool)
            t, rounds, changed = gossip_frontier_shardmap_packed(t, dirty, True, 64, **kw)
            want = (int(cases[f"{key}_rounds"]), 0)
            if (rounds, changed) != want:
                bad.append(f"rounds, changed {(rounds, changed)} != {want}")
            _check_local(t, cases[f"{key}_frontier"], f"frontier {kw}", bad)
        return go

    def columns(key, layout):
        def go(bad):
            # every column dirty: the all-gather of the summaries crosses
            # the process boundary, as the window's slabs do
            t, rounds, changed = gossip_columns_shardmap_packed(table(key, layout), None, True)
            want = (int(cases[f"{key}_rounds"]), 0)
            if (rounds, changed) != want:
                bad.append(f"rounds, changed {(rounds, changed)} != {want}")
            _check_local(t, cases[f"{key}_frontier"], "column pass", bad)
        return go

    def reconcile(key, layout):
        def go(bad):
            t = reconcile_shardmap_packed(table(key, layout))
            _check_local(t, cases[f"{key}_reconcile"], "reconcile", bad)
            # on an all-reachable ring the reconcile is the converged state
            _check_local(t, cases[f"{key}_frontier"], "reconcile == frontier", bad)
        return go

    def dense_fused(bad):
        from bullet_tpu_torch.ops.ring_kernel import frontier_tile_n

        t = table("dense32", "dense")
        dirty = torch.ones(t.shape[1] // frontier_tile_n(t.shape[1]), dtype=torch.bool)
        t, rounds, changed = gossip_frontier_shardmap_dense(
            t, dirty, True, "reference", False, 64, fuse=HALO_FUSE)
        want = (int(cases["dense32_rounds"]), 0)
        if (rounds, changed) != want:
            bad.append(f"rounds, changed {(rounds, changed)} != {want}")
        _check_local(t, cases["dense32_frontier"], "dense fused frontier", bad)

    def windows(bad):
        for m in (3, 8):
            t = table("rank1", "rank1")
            t, res = ring_window_shardmap_packed(t, True, m)
            want = int(cases[f"rank1_window{m}_residual"])
            if int(res) != want:
                bad.append(f"m {m}: residual {int(res)} != {want}")
            _check_local(t, cases[f"rank1_window{m}"], f"ring_window m={m}", bad)

    run("dense ring_round_shardmap", dense_round)
    run("packed frontier fuse 1", frontier("packed", "packed"))
    run("packed reconcile", reconcile("packed", "packed"))
    run("packed window frontier m 5", frontier("packed", "packed", window_fuse=5))
    run("dense frontier HALO_FUSE", dense_fused)
    run("rank frontier", frontier("rank", "rank"))
    run("rank reconcile", reconcile("rank", "rank"))
    run("rank1 frontier", frontier("rank1", "rank1"))
    run("rank1 reconcile", reconcile("rank1", "rank1"))
    run("rank1 ring_window m 3 and 8", windows)
    run("packed column pass", columns("packed", "packed"))
    run("rank column pass", columns("rank", "rank"))
    run("rank1 column pass", columns("rank1", "rank1"))


def sims(cases, expected, mesh, results):
    """Every cell's op sequence on a port sim over the process mesh."""
    import torch.distributed as dist

    from bullet_tpu_torch import PeerNetworkSim
    from bullet_tpu_torch.models import netsim
    from bullet_tpu_torch.ops import rank as rk

    real_routes = PeerNetworkSim._card_routes
    rk.RANK_SPAN = RANK_SPAN
    fuses = []  # (fuse, window_fuse) of every mesh frontier the sims ran
    for fn in ("gossip_frontier_shardmap_packed", "gossip_frontier_shardmap_dense"):
        def spy(*args, _real=getattr(netsim, fn), **kw):
            fuses.append((kw.get("fuse", 1), kw.get("window_fuse", 0)))
            return _real(*args, **kw)
        setattr(netsim, fn, spy)
    for name, layout, mode, topology, spmd, fused in CELLS:
        PeerNetworkSim._card_routes = (lambda self: True) if fused else real_routes
        fuses.clear()
        bad = []
        # half the cells take the mesh as a count (make_mesh over the
        # global mesh), half as the global mesh itself
        sim = PeerNetworkSim(P, capacity=N, topology=topology, mode=mode, layout=layout,
                             mesh_devices=mesh if spmd else SHARDS, use_shard_map=spmd,
                             use_kernels=True, device="cpu")
        want_route = expected[name]["route"]
        if sim._convergence_strategy()[0] != want_route:
            bad.append(f"route {sim._convergence_strategy()[0]} != {want_route}")
        for k, ((op, args), want) in enumerate(zip(ops_for(name), expected[name]["ops"])):
            got = plain(getattr(sim, op)(*args))
            if got != want["result"] or sim.last_residual != want["last_residual"]:
                bad.append(f"op {k} {op}: {got!r}, {sim.last_residual} != "
                           f"{want['result']!r}, {want['last_residual']}")
            _check_local(sim.table, [cases[f"{name}/{k}/{f}"] for f in range(want["fields"])],
                         f"op {k} {op}", bad)
        if fused and not any(max(f) > 1 for f in fuses):
            bad.append(f"no fused mesh step: {fuses}")
        if layout in ("rank", "rank1"):
            # the replicated RankIndex took the same respreads in every
            # process, and the reference's (at least one)
            mine = (sim.rank_index.epoch, sim.rank_index.rank_map().tolist())
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            if any(e != mine for e in every):
                bad.append("RankIndex differs between processes")
            if not 0 < mine[0] == expected[name]["rank_epoch"] or not np.array_equal(
                    mine[1], cases[f"{name}/rank_map"]):
                bad.append(f"RankIndex epoch {mine[0]} != {expected[name]['rank_epoch']}")
        results[f"sim {name}"] = "ok" if not bad else "; ".join(bad[:5])
    PeerNetworkSim._card_routes = real_routes


def main() -> int:
    coordinator, rank, path, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "all"
    import torch

    torch.set_num_threads(1)  # two workers beside the test run's own
    import torch.distributed as dist

    from bullet_tpu_torch.parallel.mesh import all_sum_int
    from bullet_tpu_torch.parallel.multihost import (
        global_mesh,
        host_info,
        initialize_multihost,
        is_multihost,
    )

    results = {}
    before = is_multihost()
    timeout = STALL_TIMEOUT_S if mode == "stall" else TIMEOUT_S
    initialize_multihost(coordinator, 2, rank, backend="gloo", timeout_s=timeout)
    initialize_multihost(coordinator, 2, rank, backend="gloo")  # a no-op now
    if mode in ("die", "stall"):
        if rank == 1:
            if mode == "stall":  # alive, but never at the collective
                import time

                time.sleep(4 * STALL_TIMEOUT_S)
            return 3
        all_sum_int(global_mesh(["cpu"] * PER_PROCESS), 1)  # must raise
        return 0
    mesh = global_mesh(["cpu"] * PER_PROCESS)
    info = host_info()
    results["host_info"] = "ok" if (not before and is_multihost() and info == {
        "process_index": rank, "process_count": 2, "local_devices": PER_PROCESS,
        "global_devices": SHARDS} and mesh.local == (2 * rank, 2 * rank + 1)
        and mesh.owners == (0, 0, 1, 1)) else f"{before} {info} {mesh.local} {mesh.owners}"

    cases = np.load(path)
    with open(path[:-4] + ".json") as f:
        expected = json.load(f)
    try:
        families(cases, mesh, results)
        sims(cases, expected, mesh, results)
    except Exception:  # noqa: BLE001 - the verdicts so far, then fail
        results["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    print(f"worker {rank}: {sum(v == 'ok' for v in results.values())} of {len(results)} ok",
          flush=True)
    dist.destroy_process_group()
    return 1 if "error" in results else 0


if __name__ == "__main__":
    sys.exit(main())
