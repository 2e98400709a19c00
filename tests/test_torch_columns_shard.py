"""The column pass on a mesh (``parallel/shardmap_gossip.py``
``gossip_columns_shardmap_packed``: ``ops/packed.py`` ``column_summaries``
and ``settle_columns``; on the card ``csrc/converge_columns_shard.cu``)
against the frontier loops it replaces where no cap can cut a converge
short.

On the CPU: tables of the three packed-family layouts (packed, rank,
rank1) on rings and chains of P in {4, 24}, split over one-process meshes
of 1, 2 and 4 shards, start settled and take writes (the one-card pass's
scenarios, tests/test_torch_converge_columns.py, among them an empty seed,
an all-dirty random table and a chain whose fixed point is the all-zero
entry), and writes placed against the shards: a column whose only holders
are the two rows about a shard boundary, one whose holders all sit in the
first shard (the others hold none), and one whose holders sit in the
second shard alone, so that the ring's run wraps past the last shard. The
pass, seeded with the dirty columns, must give the tables, the classic
round count and the residual of the unsharded ``gossip_frontier_packed``
and of ``gossip_frontier_shardmap_packed``, seeded with the stripes that
hold them. Sims on a 4-shard mesh with the card's routes forced take the
pass on their uncapped converges and the window frontier on a capped one,
and agree with a twin on the CPU's loop op for op. Tolerance: exact (all
int32).

On the card (``-m card``; the tests of this file need no JAX, so run them
without the suite's conftest: ``python3 -m pytest --noconftest -p
no:cacheprovider tests/test_torch_columns_shard.py -m card -s``): both
kernels against their plain versions on one 256 x 2^20 shard of each
layout at a scatter batch's dirty groups, with their device times; and,
on four cards, one NCCL process a card, a 1,024 x 2^20 ring's converge by
the pass against the window loop (#25, #26) from the same state, and a
sim whose capped converge still takes the window loop."""

from __future__ import annotations

import json
import os
import socket

import numpy as np
import pytest
import torch

from bullet_tpu_torch import PeerNetworkSim, _build
from bullet_tpu_torch.convert import TABLE_TYPES
from bullet_tpu_torch.models import netsim
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.parallel.mesh import Mesh, ShardedTable, shard_fields
from bullet_tpu_torch.parallel.shardmap_gossip import (
    gossip_columns_shardmap_packed,
    gossip_frontier_shardmap_packed,
)
from test_torch_converge_columns import N, SCENARIOS, TILE, entry_pool, scenario, stripe_seed

torch.set_num_threads(2)

LAYOUT = {3: "packed", 2: "rank", 1: "rank1"}
# holders placed against the shards: across the first boundary, all in the
# first shard, in the second shard alone (a ring's run wraps past the last)
PLACED = ("boundary_holders", "first_shard_holds", "wrapping_run")


def top_entry(nf: int) -> np.ndarray:
    """An entry of an nf-field layout that beats every one of
    ``entry_pool``'s (rank's cv a function of its rank)."""
    if nf == 3:
        return np.array([5, 0, (7 << pk.CV_SHIFT) | 1], dtype=np.int32)
    rank = (1 << 30) + 7
    if nf == 1:
        return np.array([rank], dtype=np.int32)
    return np.array([rank, (((rank % 7) + 1) << pk.CV_SHIFT) | (rank % (1 << 20))],
                    dtype=np.int32)


def placed(name: str, nf: int, p: int, shards: int, seed: int):
    """(table [nf, P, N], dirty columns bool [N]): a settled table whose
    dirty columns take a winning entry at rows placed against the shards
    (with one shard, where those rows fall)."""
    rng = np.random.default_rng(seed)
    pool = entry_pool(rng, nf, 48)
    pick = rng.integers(-1, len(pool), N)
    col = np.where(pick[:, None] >= 0, pool[pick], 0).T
    table = np.repeat(col[:, None, :], p, axis=1).astype(np.int32)
    b = p // shards
    rows = {"boundary_holders": [b - 1, b % p],
            "first_shard_holds": list(range(0, b, 2)),
            "wrapping_run": [b % p, (b + b // 2) % p]}[name]
    dirty = np.zeros(N, dtype=bool)
    cols = rng.choice(N, 12, replace=False)
    for c in cols:
        for r in rows:
            table[:, r, c] = top_entry(nf)
    dirty[cols] = True
    return table, dirty


def case(name: str, nf: int, p: int, shards: int, seed: int):
    if name in PLACED:
        return placed(name, nf, p, shards, seed)
    return scenario(name, nf, p, seed)


def sharded(fields: np.ndarray, nf: int, shards: int):
    return shard_fields(list(fields), Mesh(["cpu"] * shards), TABLE_TYPES[LAYOUT[nf]])


@pytest.mark.parametrize("name", SCENARIOS + PLACED)
@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("p", [4, 24])
@pytest.mark.parametrize("wrap", [True, False], ids=["ring", "chain"])
def test_sharded_pass_matches_the_frontier_loops(wrap, p, shards, nf, name):
    fields, dirty = case(name, nf, p, shards, seed=1000 * p + 10 * nf + shards)
    diameter = p // 2 if wrap else p - 1
    # the smallest cap the pass is taken at (as the one-card pass's)
    max_rounds = max(diameter, 1) + 1
    want, w_rounds, w_left = pk.gossip_frontier_packed(
        TABLE_TYPES[LAYOUT[nf]](*(torch.from_numpy(f.copy()) for f in fields)),
        stripe_seed(dirty), wrap, max_rounds, fuse=1, tile_n=TILE)
    loop, l_rounds, l_left = gossip_frontier_shardmap_packed(
        sharded(fields, nf, shards), stripe_seed(dirty), wrap, max_rounds, tile_n=TILE)
    got, g_rounds, g_left = gossip_columns_shardmap_packed(
        sharded(fields, nf, shards), dirty, wrap)
    for a, b, c in zip(got.to_numpy(), want, loop.to_numpy()):
        assert np.array_equal(a, b.numpy()) and np.array_equal(a, c)
    assert (g_rounds, g_left) == (w_rounds, w_left) == (l_rounds, l_left) and g_left == 0
    if name == "empty_seed":
        assert g_rounds == 0
    elif name in PLACED:
        assert g_rounds >= 2  # some rows took the write


def test_holder_runs_and_summaries():
    """The runs of rows that do not hold, and a summary's words: the join,
    pre | suf << 16, best."""
    held = torch.tensor([[0, 1, 0, 1], [0, 0, 1, 1], [0, 0, 0, 1], [0, 1, 1, 1],
                         [0, 0, 0, 1]], dtype=torch.bool)
    pre, suf, best = pk.holder_runs(held)
    assert (pre.tolist(), suf.tolist(), best.tolist()) == ([5, 0, 1, 0], [5, 1, 1, 0],
                                                           [5, 2, 1, 0])
    rank1 = (torch.tensor([[3] * 16, [7] * 16, [7] * 16, [1] * 16], dtype=torch.int32),)
    out = torch.zeros((1, 16, 3), dtype=torch.int32)
    pk.column_summaries(rank1, torch.zeros(1, dtype=torch.int32), out)
    assert out[0, 0].tolist() == [7, 1 | (1 << 16), 1] and bool((out == out[:, :1]).all())


def test_settle_depth_and_no_group():
    """A ring of two shards whose only holder is the last row of the
    second: the run wraps past it, every row of the first shard takes the
    join, and the depth is the ring's half; with no dirty group nothing
    launches, changes or is read."""
    fields = np.zeros((1, 8, 16), dtype=np.int32)
    fields[0, 7, 5] = 9
    table = sharded(fields, 1, 2)
    got, rounds, left = gossip_columns_shardmap_packed(table, np.eye(16, dtype=bool)[5], True)
    assert (rounds, left) == (4 + 1, 0) and bool((got.to_numpy()[0][:, 5] == 9).all())
    fields[0, 3, 2] = 4
    table = sharded(fields, 1, 2)
    assert gossip_columns_shardmap_packed(table, np.zeros(16, dtype=bool), True)[1:] == (0, 0)
    assert np.array_equal(table.to_numpy()[0], fields[0])


@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_mesh_sim_takes_the_pass(monkeypatch, layout, topology):
    """A sim on a 4-shard mesh with the card's routes forced takes the pass
    on each uncapped converge and the window frontier on a capped one;
    every op's result, table and residual equal a twin's on the CPU's
    frontier loop, through untracked rounds, a capped converge and a
    reconcile."""
    calls = {"pass": 0, "loop": 0}
    for key, name in (("pass", "gossip_columns_shardmap_packed"),
                      ("loop", "gossip_frontier_shardmap_packed")):
        real = getattr(netsim, name)

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(netsim, name, counted)
    kw = dict(capacity=512, topology=topology, layout=layout, device="cpu", use_kernels=True,
              mesh_devices=4, use_shard_map=True)
    forced, twin = PeerNetworkSim(32, **kw), PeerNetworkSim(32, **kw)
    forced._card_routes = lambda: True
    ops = ["put", "converge", "put", "converge", "put", "step1", "put", "converge", "put",
           "capped", "converge", "put", "reconcile", "put", "put", "converge"]
    for i, op in enumerate(ops):
        before = dict(calls)
        if op == "put":
            rng = np.random.default_rng(i)
            k = int(rng.integers(1, 60))
            peers, keys, values = (rng.integers(0, 32, k), rng.integers(0, 400, k),
                                   rng.integers(-9, 9, k))
            for sim in (forced, twin):
                sim.put_bulk(peers, [f"k/{int(x)}" for x in keys], values)
                sim.step(0)
            got = want = None
        elif op == "converge":
            got, want = forced.run_until_converged(), twin.run_until_converged()
            assert calls["pass"] == before["pass"] + 1, i
        elif op == "step1":
            got, want = forced.step(1), twin.step(1)
        elif op == "capped":
            got, want = (sim.run_until_converged(max_rounds=3) for sim in (forced, twin))
            assert calls["pass"] == before["pass"], i
        else:
            got, want = forced.reconcile(), twin.reconcile()
        assert got == want and forced.last_residual == twin.last_residual, (i, op)
        for a, b in zip(forced.table.to_numpy(), twin.table.to_numpy()):
            assert np.array_equal(a, b), (i, op)
    # the twin's converges (the CPU's routes) all took the loop
    assert calls["pass"] == ops.count("converge")


# ---------------------------------------------------------------- the card

SHARD_ROWS, SLOTS = 256, 1 << 20
SCATTER_COLUMNS = 49_300  # a scatter batch's dirty columns (PERF.md §4)
SIM_PEERS, SIM_CAPACITY = 1024, 1 << 16


def _needs_cards(count: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} CUDA card{'s' if count > 1 else ''}")


def scatter_shard(nf: int, seed: int, shard: int, shards: int, rows: int, dev):
    """A shard of a settled [rows x shards, SLOTS] table whose scatter batch
    of dirty columns each took one to three writes at random global rows
    (this shard's only), some winning, as a write batch leaves it; and the
    dirty columns. The same seed gives every shard of one table."""
    rng = np.random.default_rng(seed)
    pool = entry_pool(rng, nf, 4096)
    base = torch.from_numpy(pool[rng.integers(0, len(pool), SLOTS)].T.copy()).to(dev)
    fields = [f.expand(rows, SLOTS).contiguous() for f in base]
    cols = np.sort(rng.choice(SLOTS, SCATTER_COLUMNS, replace=False))
    for _ in range(3):
        at = rng.integers(0, rows * shards, cols.size)
        val = pool[rng.integers(0, len(pool), cols.size)]
        mine = at // rows == shard
        r = torch.from_numpy(at[mine] % rows).to(dev)
        c = torch.from_numpy(cols[mine]).to(dev)
        for f, v in zip(fields, val[mine].T):
            f[r, c] = torch.from_numpy(v.copy()).to(dev)
    dirty = np.zeros(SLOTS, dtype=bool)
    dirty[cols] = True
    return TABLE_TYPES[LAYOUT[nf]](*fields), dirty


def _device_ms(fn, reps: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
@pytest.mark.parametrize("nf", [3, 2, 1])
def test_kernels_match_plain_on_card(nf):
    """Both kernels against their plain versions (run on the card's
    tensors) at one 256 x 2^20 shard of a 4-shard ring and chain, on a
    scatter batch's dirty groups: the summaries word for word, the settled
    shard and its depth bit for bit. Prints each kernel's device ms (CUDA
    events, 5 launches), its bytes and the plain version's ms."""
    _needs_cards(1)
    dev = torch.device("cuda", 0)
    shards = 4
    tables = [scatter_shard(nf, 11, s, shards, SHARD_ROWS, dev) for s in range(shards)]
    dirty = tables[0][1]
    groups = pk.column_groups(dirty, SLOTS)
    ids = torch.from_numpy(np.append(groups, np.int32(0))).to(dev)
    shape = (shards, groups.size, pk.COLUMN_GROUP, nf + pk.SUMMARY_RUN_WORDS)
    sums = torch.zeros(shape, dtype=torch.int32, device=dev)
    for s, (table, _) in enumerate(tables):
        pk.column_summaries(table, ids[:-1], sums[s])
        plain = pk.column_summaries_torch(table, ids[:-1], torch.zeros_like(sums[s]))
        assert torch.equal(sums[s], plain), s
    table = tables[1][0]
    summarise_ms = _device_ms(lambda: pk.column_summaries(table, ids[:-1], sums[1]))
    plain_ms = _device_ms(lambda: pk.column_summaries_torch(table, ids[:-1], sums[1]), 1)
    read = groups.size * SHARD_ROWS * pk.COLUMN_GROUP * nf * 4
    print(f"\ncolumn_summaries {LAYOUT[nf]}: {groups.size} groups, {summarise_ms:.3f} ms device, "
          f"{read / 1e9:.3f} GB read, floor {read / 3.35e12 * 1e3:.3f} ms; plain {plain_ms:.1f} ms")
    for wrap in (True, False):
        for s, (table, _) in enumerate(tables):
            mine = [f.clone() for f in table]
            twin = [f.clone() for f in table]
            cell = ids.clone()
            pk.settle_columns(mine, cell, sums, s, wrap)
            plain = ids.clone()
            pk.settle_columns_torch(twin, plain, sums, wrap)
            assert int(cell[-1]) == int(plain[-1]) > 0, (wrap, s)
            for a, b in zip(mine, twin):
                assert torch.equal(a, b), (wrap, s)
            del mine, twin
    cell = ids.clone()
    settle_ms = _device_ms(lambda: pk.settle_columns(tables[1][0], cell, sums, 1, True))
    plain_ms = _device_ms(lambda: pk.settle_columns_torch(tables[1][0], cell, sums, True), 1)
    print(f"settle_columns {LAYOUT[nf]}: {settle_ms:.3f} ms device (at most {read / 1e9:.3f} GB "
          f"written); plain {plain_ms:.1f} ms")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _four_card_worker(rank: int, port: int, out_dir: str) -> None:
    """One process a card: the 1,024 x 2^20 ring's pass against the window
    loop from one state, then a sim's capped and uncapped converges."""
    import time

    import torch.distributed as dist

    from bullet_tpu_torch.parallel.multihost import global_mesh, initialize_multihost

    initialize_multihost(f"localhost:{port}", 4, rank)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    mesh = global_mesh([dev])  # one shard a process
    bad, seen = [], {}
    for wrap in (True, False):
        table, dirty = scatter_shard(3, 23, rank, 4, SHARD_ROWS, dev)
        window = pk.window_frontier_depth(SHARD_ROWS, SLOTS)
        tile = pk.frontier_tile_n(SLOTS)
        twin = [f.clone() for f in table]
        shards = [None] * 4
        shards[rank] = table
        st = ShardedTable(shards, mesh)
        shards = [None] * 4
        shards[rank] = type(table)(*twin)
        tw = ShardedTable(shards, mesh)
        seed = torch.from_numpy(dirty.reshape(-1, tile).any(1)).to(dev)
        diameter = 2 * SHARD_ROWS if wrap else 4 * SHARD_ROWS - 1
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        _, w_rounds, w_left = gossip_frontier_shardmap_packed(
            tw, seed, wrap, diameter + 1, window_fuse=window, tile_n=tile)
        torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        _build.reset_launches()
        _, g_rounds, g_left = gossip_columns_shardmap_packed(st, dirty, wrap)
        torch.cuda.synchronize()
        dist.barrier()
        t2 = time.perf_counter()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        if (g_rounds, g_left) != (w_rounds, w_left):
            bad.append(f"wrap {wrap}: {(g_rounds, g_left)} != {(w_rounds, w_left)}")
        if not all(torch.equal(a, b) for a, b in zip(table, twin)):
            bad.append(f"wrap {wrap}: the tables differ")
        if launches != {"column_summaries": 1, "settle_columns": 1}:
            bad.append(f"wrap {wrap}: launches {launches}")
        seen[f"wrap {wrap}"] = {"rounds": g_rounds, "window_s": t1 - t0, "pass_s": t2 - t1}
        del table, twin, st, tw
    # a sim: its capped converge takes the window loop (#25, #26), its
    # uncapped one the pass
    sim = PeerNetworkSim(SIM_PEERS, capacity=SIM_CAPACITY, topology="ring", layout="packed",
                         device=dev, mesh_devices=mesh, use_shard_map=True)
    rng = np.random.default_rng(5)
    keys = [f"k/{int(x)}" for x in rng.integers(0, SIM_CAPACITY // 8, 4096)]
    sim.put_bulk(rng.integers(0, SIM_PEERS, 4096), keys, rng.integers(0, 99, 4096))
    sim.step(0)
    for name, cap in (("capped", sim.topology.diameter - 12), ("uncapped", 1 << 30)):
        _build.reset_launches()
        rounds = sim.run_until_converged(max_rounds=cap)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        seen[name] = {"rounds": rounds, "residual": sim.last_residual, "launches": launches}
    if not seen["capped"]["launches"].get("frontier_shard_window"):
        bad.append(f"the capped converge took no window step: {seen['capped']}")
    if seen["capped"]["launches"].get("column_summaries"):
        bad.append("the capped converge took the pass")
    if seen["uncapped"]["launches"] != {"column_summaries": 1, "settle_columns": 1}:
        bad.append(f"the uncapped converge: {seen['uncapped']}")
    if seen["uncapped"]["residual"] != 0 or not sim.converged():
        bad.append(f"not converged: {seen['uncapped']}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"bad": bad, "seen": seen}, f)
    dist.destroy_process_group()


@pytest.mark.card
def test_four_card_pass_matches_the_window_loop(tmp_path):
    """Four NCCL processes, one a card: each shard, round count and residual
    of the pass equal the window loop's from the same state, ring and
    chain, every process alike; a mesh sim's converge capped below the
    diameter takes the window loop, its uncapped one the pass."""
    _needs_cards(4)
    import torch.multiprocessing as mp

    _build.library()  # once, before the processes load it
    mp.spawn(_four_card_worker, args=(_free_port(), str(tmp_path)), nprocs=4)
    got = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    print("\n" + json.dumps(got[0]["seen"]))
    for r, g in enumerate(got):
        assert not g["bad"], (r, g["bad"])
        assert g["seen"]["wrap True"]["rounds"] == got[0]["seen"]["wrap True"]["rounds"]
