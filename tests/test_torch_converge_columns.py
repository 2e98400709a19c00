"""The column pass (``ops/packed.py`` ``converge_columns_packed`` and
``gossip_columns_packed``; on the card ``csrc/converge_columns.cu``)
against the compacting frontier loop it replaces where no cap can cut a
converge short.

Tables of the three packed-family layouts (packed, rank, rank1) on rings
and chains of P in {1, 2, 3, 24, 25, 64} start settled, then take writes
on some columns: a single winning row, several rows holding the same
winner, winners of different rows, losing writes, columns with clean
neighbours inside their 16-column group; an empty seed; and an all-dirty
seed over a random table, also one of entries around the all-zero entry a
chain's ends compare against, with columns wholly below it (no sim writes
such entries; the kernels' random tables hold them). The column pass's
plain version, seeded with
the dirty columns, must give the tables, the classic round count and the
residual of ``gossip_frontier_packed`` at fuse 1 and at STRIPE_FUSE seeded
with the stripes that hold them. Tolerance: exact (all int32)."""

import numpy as np
import pytest
import torch

from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.ops import packed as pk

torch.set_num_threads(2)

N, TILE = 256, 32  # 8 stripes of 32 columns, 16 groups of 16


def entry_pool(rng, nf: int, k: int) -> np.ndarray:
    """k distinct live entries of an nf-field layout, [k, nf] int32. Each
    beats the all-zero entry (cls or rank > 0), and equal keys mean equal
    entries: rank's cv is a function of its rank."""
    if nf == 3:
        cls = rng.integers(1, 8, k)
        vid = rng.choice(1 << 20, k, replace=False)
        khi = rng.integers(-3, 3, k)  # few values: compares reach klo and cv
        klo = rng.integers(-(1 << 31), 1 << 31, k)
        return np.stack([khi, klo, (cls << pk.CV_SHIFT) | vid], 1).astype(np.int32)
    rank = rng.choice(1 << 30, k, replace=False) + 1
    if nf == 1:
        return rank[:, None].astype(np.int32)
    cv = (((rank % 7) + 1) << pk.CV_SHIFT) | (rank % (1 << 20))
    return np.stack([rank, cv], 1).astype(np.int32)


def settled(rng, nf: int, p: int, pool: np.ndarray) -> np.ndarray:
    """A table at a fixed point, [nf, P, N]: every column one entry of the
    pool or absent (all zero)."""
    pick = rng.integers(-1, len(pool), N)
    col = np.where(pick[:, None] >= 0, pool[pick], 0).T  # [nf, N]
    return np.repeat(col[:, None, :], p, axis=1).astype(np.int32)


def around_zero(rng, nf: int, k: int):
    """k distinct entries near the all-zero entry, [k, nf] int32, and which
    of them lie below it: packed cls 0 or 1 with small keys, ranks of
    either sign (rank's cv a function of its rank)."""
    if nf == 3:
        keys = np.unique(np.stack([rng.integers(0, 2, 4 * k), rng.integers(-3, 3, 4 * k),
                                   rng.integers(-3, 3, 4 * k), rng.integers(0, 3, 4 * k)], 1),
                         axis=0)
        keys = keys[rng.permutation(len(keys))[:k]]
        cls, khi, klo, vid = keys.T
        below = (cls == 0) & ((khi < 0) | ((khi == 0) & (klo < 0)))
        pool = np.stack([khi, klo, (cls << pk.CV_SHIFT) | vid], 1)
        return pool.astype(np.int32), below
    rank = rng.choice(np.arange(-40, 8), k, replace=False)
    pool = rank[:, None] if nf == 1 else np.stack([rank, np.abs(rank) * 3], 1)
    return pool.astype(np.int32), rank < 0


SCENARIOS = ("one_holder", "several_holders", "mixed_writes", "empty_seed", "all_dirty",
             "around_zero")


def scenario(name: str, nf: int, p: int, seed: int):
    """(table [nf, P, N], dirty columns bool [N] or None for all)."""
    rng = np.random.default_rng(seed)
    pool = entry_pool(rng, nf, 48)
    table = settled(rng, nf, p, pool)
    dirty = np.zeros(N, dtype=bool)
    if name == "empty_seed":
        return table, dirty
    if name == "all_dirty":
        pick = rng.integers(-1, len(pool), (p, N))
        table = np.where(pick[..., None] >= 0, pool[pick], 0).transpose(2, 0, 1)
        return np.ascontiguousarray(table, dtype=np.int32), None
    if name == "around_zero":
        pool, below = around_zero(rng, nf, 24)
        pick = rng.integers(0, len(pool), (p, N))
        # the first 64 columns wholly below the all-zero entry
        low = np.flatnonzero(below)
        pick[:, :64] = low[rng.integers(0, len(low), (p, 64))]
        table = pool[pick].transpose(2, 0, 1)
        return np.ascontiguousarray(table, dtype=np.int32), None
    # a few dirty columns in some groups, their group neighbours clean, and
    # whole stripes left clean
    cols = rng.choice(np.arange(0, N, 3), 12, replace=False)
    for c in cols:
        if name == "one_holder":
            rows = rng.integers(0, p, 1)
        elif name == "several_holders":
            rows = rng.choice(p, min(p, int(rng.integers(2, 6))), replace=False)
        else:
            rows = rng.integers(0, p, int(rng.integers(1, 5)))
        same = pool[rng.integers(len(pool))]
        for r in rows:
            # several holders share one entry; mixed writes draw each anew,
            # so some lose to the column's entry and others tie among rows
            table[:, r, c] = same if name != "mixed_writes" else pool[rng.integers(len(pool))]
        dirty[c] = True
    return table, dirty


def to_table(fields: np.ndarray):
    return tuple(torch.from_numpy(f.copy()) for f in fields)


def stripe_seed(dirty):
    if dirty is None:
        return torch.ones(N // TILE, dtype=torch.bool)
    return torch.from_numpy(dirty.reshape(N // TILE, TILE).any(1))


@pytest.mark.parametrize("fuse", [1, pk.STRIPE_FUSE])
@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("p", [1, 2, 3, 24, 25, 64])
@pytest.mark.parametrize("wrap", [True, False], ids=["ring", "chain"])
def test_column_pass_matches_the_frontier_loop(wrap, p, nf, name, fuse):
    fields, dirty = scenario(name, nf, p, seed=1000 * p + 10 * nf + SCENARIOS.index(name))
    diameter = p // 2 if wrap else p - 1
    # the smallest cap the column pass is taken at: the loop reaches round
    # L + 1 (a lone row of a chain may take one round from its ends)
    max_rounds = max(diameter, 1) + 1
    want, w_rounds, w_left = pk.gossip_frontier_packed(
        to_table(fields), stripe_seed(dirty), wrap, max_rounds, fuse=fuse, tile_n=TILE)
    got, g_rounds, g_left = pk.gossip_columns_packed(to_table(fields), dirty, wrap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (g_rounds, g_left) == (w_rounds, w_left) and g_left == 0
    if name == "empty_seed":
        assert g_rounds == 0
    else:
        assert g_rounds >= 1 and all(bool((f == f[0:1]).all()) for f in got)


@pytest.mark.parametrize("wrap", [True, False], ids=["ring", "chain"])
def test_holder_distances(wrap):
    """Each row's distance to its column's nearest holder, against a
    direct minimum over the holders."""
    rng = np.random.default_rng(7)
    p = 13
    held = rng.random((p, 40)) < 0.2
    held[rng.integers(0, p, 40), np.arange(40)] = True
    got = pk.holder_distances(torch.from_numpy(held), wrap).numpy()
    for c in range(40):
        for r in range(p):
            d = np.abs(np.flatnonzero(held[:, c]) - r)
            if wrap:
                d = np.minimum(d, p - d)
            assert got[r, c] == d.min(), (r, c)


def test_column_groups_and_fit():
    """The 16-column groups that hold a dirty column, and the shapes a
    block's shared memory takes."""
    dirty = np.zeros(64, dtype=bool)
    dirty[[0, 7, 9, 40, 63]] = True
    assert pk.column_groups(dirty, 64).tolist() == [0, 2, 3]
    assert pk.column_groups(torch.from_numpy(dirty), 64).tolist() == [0, 2, 3]
    assert pk.column_groups(None, 64).tolist() == list(range(4))
    assert pk.column_groups(np.zeros(64, dtype=bool), 64).size == 0
    # P = 1,024 rows of packed entries: 192 KB of table, 16 KB of flags
    assert pk.column_pass_smem(1024, 3) == 196608 + 16384 + 2048
    for nf, most in ((3, 1087), (2, 1564), (1, 2784)):
        assert pk.column_pass_fits(most, 1 << 20, nf)
        assert not pk.column_pass_fits(most + 1, 1 << 20, nf)
    assert not pk.column_pass_fits(64, 100, 3)  # not whole groups


def test_plain_pass_depth_and_loop_span():
    """The plain pass returns the largest distance (-1 with no group), and
    the loop reports the rounds and the residual of the frontier loop."""
    fields = np.zeros((1, 5, 16), dtype=np.int32)
    fields[0, 1, 3] = 9  # one holder in a chain of 5: row 4 is 3 rows away
    table = to_table(fields)
    _, depth = pk.converge_columns_packed(table, np.eye(16, dtype=bool)[3], False)
    assert int(depth) == 3 and bool((table[0][:, 3] == 9).all())
    _, depth = pk.converge_columns_packed(table, np.zeros(16, dtype=bool), False)
    assert int(depth) == -1
    table = to_table(fields)
    assert pk.gossip_columns_packed(table, None, True)[1:] == (3, 0)  # ring: 2 away, + 1


@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_sim_takes_the_pass_with_its_group_marks(layout, topology):
    """A sim keeps its dirty 16-column groups beside its dirty columns. With
    the card's routes forced, each uncapped converge takes the pass with
    those groups, and every op's result, table and residual equal a twin's
    on the CPU's frontier loop, through untracked rounds, a capped converge
    and a reconcile."""
    kw = dict(capacity=512, topology=topology, layout=layout, device="cpu", use_kernels=True)
    forced, twin = PeerNetworkSim(16, **kw), PeerNetworkSim(16, **kw)
    forced._card_routes = lambda: True
    ops = ["put", "converge", "put", "converge", "put", "step1", "put", "converge", "put",
           "capped", "converge", "put", "reconcile", "put", "put", "converge"]
    for i, op in enumerate(ops):
        if op == "put":
            rng = np.random.default_rng(i)
            k = int(rng.integers(1, 60))
            peers, keys, values = (rng.integers(0, 16, k), rng.integers(0, 400, k),
                                   rng.integers(-9, 9, k))
            for sim in (forced, twin):
                sim.put_bulk(peers, [f"k/{int(x)}" for x in keys], values)
                sim.step(0)
            got = want = None
            cols = forced._marks.columns()
            if cols is not None:
                assert np.array_equal(forced._marks.groups(),
                                      pk.column_groups(cols, 512))
        elif op == "converge":
            got, want = forced.run_until_converged(), twin.run_until_converged()
        elif op == "step1":
            got, want = forced.step(1), twin.step(1)
        elif op == "capped":
            got, want = (sim.run_until_converged(max_rounds=2) for sim in (forced, twin))
        else:
            got, want = forced.reconcile(), twin.reconcile()
        assert got == want and forced.last_residual == twin.last_residual, (i, op)
        for a, b in zip(forced.table, twin.table):
            assert torch.equal(a, b), (i, op)
