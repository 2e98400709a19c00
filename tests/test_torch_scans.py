"""The query scans (bullet_tpu_torch/ops/scans.py) against the JAX
functions of bullet_tpu/ops/scans.py on the same tables, structs and
probes made from a numpy seed: the [P, N] masks of a dense 7-field table,
the row forms and counts, the subtree mask, the rank-native masks of a
rank1 row, and the sims' row views of the packed family (packed, rank,
rank1; the reference's ``_peer_row_*``) on random tables whose vids run
past the key tables. Probe scalars go in as Python ints and as 0-d
tensors. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.models import netsim as jax_netsim
from bullet_tpu.ops import merge as jax_merge
from bullet_tpu.ops import packed as jax_packed
from bullet_tpu.ops import rank as jax_rank
from bullet_tpu.ops import scans as js
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.ops import scans as ps
from bullet_tpu_torch.ops.merge import TableState
from bullet_tpu_torch.ops.packed import PackedTable
from bullet_tpu_torch.ops.rank import Rank1Table, RankTable

torch.set_num_threads(2)

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
# few distinct key halves, the extremes among them, so that equal khi and
# the klo tie-break are common
KEY_HALVES = np.array([I32_MIN, I32_MIN + 1, -7, -1, 0, 1, 5, I32_MAX - 1, I32_MAX], np.int32)


def dense_table(rng, p, n):
    cls = rng.integers(0, 5, (p, n))
    khi = rng.choice(KEY_HALVES, (p, n))
    klo = rng.choice(KEY_HALVES, (p, n))
    vid = rng.integers(0, 12, (p, n))
    meta = [rng.integers(-3, 50, (p, n)) for _ in range(3)]
    return [np.ascontiguousarray(a, dtype=np.int32) for a in (cls, khi, klo, vid, *meta)]


def path_struct(rng, n):
    parent = rng.integers(-1, 6, n)
    parent2 = np.where(parent >= 0, rng.integers(-1, 4, n), -1)
    seg = rng.integers(-1, 5, n)
    return [np.ascontiguousarray(a, dtype=np.int32) for a in (parent, parent2, seg)]


def both(arrays, ctor_j, ctor_p):
    return (ctor_j(*(jnp.asarray(a) for a in arrays)),
            ctor_p(*(torch.from_numpy(a.copy()) for a in arrays)))


def scalar(x, as_tensor):
    return torch.tensor(x, dtype=torch.int32) if as_tensor else int(x)


def same(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), what)


def key_bounds(rng):
    """(lo_hi, lo_lo, hi_hi, hi_lo): mostly ordered, some empty intervals."""
    return [int(x) for x in rng.choice(KEY_HALVES, 4)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_table_masks_match_reference(seed, as_tensor):
    rng = np.random.default_rng(seed)
    p, n = 5, 300 + seed
    jt, pt = both(dense_table(rng, p, n), jax_merge.TableState, TableState)
    jst, pst = both(path_struct(rng, n), js.PathStruct, ps.PathStruct)
    for _ in range(12):
        base, field, vid = int(rng.integers(-1, 6)), int(rng.integers(-1, 5)), int(rng.integers(0, 13))
        keys = key_bounds(rng)
        s = lambda x: scalar(x, as_tensor)  # noqa: E731
        j = lambda x: jnp.int32(x)  # noqa: E731
        cases = [
            (ps.equals_field_mask(pt, pst, s(base), s(field), s(vid)),
             js.equals_field_mask(jt, jst, j(base), j(field), j(vid))),
            (ps.equals_leaf_mask(pt, pst, s(base), s(vid)),
             js.equals_leaf_mask(jt, jst, j(base), j(vid))),
            (ps.range_field_mask(pt, pst, s(base), s(field), *map(s, keys)),
             js.range_field_mask(jt, jst, j(base), j(field), *map(j, keys))),
            (ps.range_leaf_mask(pt, pst, s(base), *map(s, keys)),
             js.range_leaf_mask(jt, jst, j(base), *map(j, keys))),
        ]
        for got, want in cases:
            same(got, want)
            same(ps.count_mask(got), js.count_mask(want))
            assert ps.count_mask(got).dtype == torch.int32
    member = rng.random(n) < 0.4
    same(ps.subtree_leaf_mask(pt, torch.from_numpy(member)),
         js.subtree_leaf_mask(jt, jnp.asarray(member)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_row_forms_match_reference(seed, as_tensor):
    rng = np.random.default_rng(10 + seed)
    p, n = 4, 257
    jt, pt = both(dense_table(rng, p, n), jax_merge.TableState, TableState)
    jst, pst = both(path_struct(rng, n), js.PathStruct, ps.PathStruct)
    for peer in range(p):
        jrow, prow = js.peer_row(jt, jnp.int32(peer)), ps.peer_row(pt, peer)
        for a, b in zip(prow, jrow):
            same(a, b)
        for _ in range(8):
            base, field, vid = (int(rng.integers(-1, 6)), int(rng.integers(-1, 5)),
                                int(rng.integers(0, 13)))
            keys = key_bounds(rng)
            s = lambda x: scalar(x, as_tensor)  # noqa: E731
            j = lambda x: jnp.int32(x)  # noqa: E731
            same(ps.equals_field_mask_row(prow, pst, s(base), s(field), s(vid)),
                 js.equals_field_mask_row(jrow, jst, j(base), j(field), j(vid)))
            same(ps.equals_leaf_mask_row(prow, pst, s(base), s(vid)),
                 js.equals_leaf_mask_row(jrow, jst, j(base), j(vid)))
            same(ps.range_field_mask_row(prow, pst, s(base), s(field), *map(s, keys)),
                 js.range_field_mask_row(jrow, jst, j(base), j(field), *map(j, keys)))
            same(ps.range_leaf_mask_row(prow, pst, s(base), *map(s, keys)),
                 js.range_leaf_mask_row(jrow, jst, j(base), *map(j, keys)))
            got = ps.equals_field_count_row(prow, pst, s(base), s(field), s(vid))
            assert got.dtype == torch.int32 and got.dim() == 0
            same(got, js.equals_field_count_row(jrow, jst, j(base), j(field), j(vid)))
            same(ps.equals_leaf_count_row(prow, pst, s(base), s(vid)),
                 js.equals_leaf_count_row(jrow, jst, j(base), j(vid)))


@pytest.mark.parametrize("seed", range(4))
def test_rank_native_masks_match_reference(seed):
    rng = np.random.default_rng(20 + seed)
    n = 300
    ranks = np.array([0, 1, 2, 100, 1 << 20, I32_MAX - 1, I32_MAX], np.int32)
    row = rng.choice(ranks, n).astype(np.int32)
    jrow, prow = jnp.asarray(row), torch.from_numpy(row.copy())
    jst, pst = both(path_struct(rng, n), js.PathStruct, ps.PathStruct)
    for _ in range(16):
        base, field = int(rng.integers(-1, 6)), int(rng.integers(-1, 5))
        rank, lo, hi = (int(x) for x in rng.choice(ranks, 3))
        j = jnp.int32
        same(ps.equals_field_mask_rank(prow, pst, base, field, rank),
             js.equals_field_mask_rank(jrow, jst, j(base), j(field), j(rank)))
        same(ps.equals_leaf_mask_rank(prow, pst, base, rank),
             js.equals_leaf_mask_rank(jrow, jst, j(base), j(rank)))
        same(ps.range_field_mask_rank(prow, pst, base, field, lo, hi),
             js.range_field_mask_rank(jrow, jst, j(base), j(field), j(lo), j(hi)))
        same(ps.range_leaf_mask_rank(prow, pst, base, lo, hi),
             js.range_leaf_mask_rank(jrow, jst, j(base), j(lo), j(hi)))
        same(ps.equals_field_count_rank(prow, pst, base, field, rank),
             js.equals_field_count_rank(jrow, jst, j(base), j(field), j(rank)))
        same(ps.equals_leaf_count_rank(prow, pst, base, rank),
             js.equals_leaf_count_rank(jrow, jst, j(base), j(rank)))


def _key_tables(rng, k):
    """(cls, khi, klo) maps of k vids; the tables below hold vids past k,
    which both gathers clamp."""
    return (rng.integers(1, 5, k).astype(np.int32), rng.choice(KEY_HALVES, k),
            rng.choice(KEY_HALVES, k))


def _port_sim(layout, table, key_tables, inverse=None):
    """A port sim whose table, key tables and rank inverse are the given
    ones (its host holds none of them)."""
    sim = PeerNetworkSim(table[0].shape[0], capacity=table[0].shape[1], layout=layout,
                         device="cpu")
    sim.table = table
    sim.host.key_tables = lambda: tuple(a.copy() for a in key_tables)
    if inverse is not None:
        sim.rank_index._svids = inverse[1].astype(np.int64)
        sim.rank_index._sranks = inverse[0].astype(np.int64)
    return sim


@pytest.mark.parametrize("seed", range(3))
def test_packed_family_row_views_match_reference(seed):
    rng = np.random.default_rng(30 + seed)
    p, n, k = 3, 200, 40
    maps = _key_tables(rng, k)
    cv = np.where(rng.random((p, n)) < 0.7,
                  (rng.integers(1, 5, (p, n)) << 28) | rng.integers(0, k + 8, (p, n)), 0)
    cv = cv.astype(np.int32)
    khi, klo = rng.choice(KEY_HALVES, (p, n)), rng.choice(KEY_HALVES, (p, n))
    # packed
    jt, pt = both([khi, klo, cv], jax_packed.PackedTable, PackedTable)
    sim = _port_sim("packed", pt, maps)
    for peer in range(p):
        for a, b in zip(sim._peer_row(peer), jax_netsim._peer_row_packed(jt, jnp.int32(peer))):
            same(a, b, "packed")
    # rank: keys rebuilt through the maps
    rank = rng.integers(0, 1 << 30, (p, n)).astype(np.int32)
    jt, pt = both([rank, cv], jax_rank.RankTable, RankTable)
    sim = _port_sim("rank", pt, maps)
    for peer in range(p):
        want = jax_netsim._peer_row_rank(jt, jnp.int32(peer), jnp.asarray(maps[1]),
                                         jnp.asarray(maps[2]))
        for a, b in zip(sim._peer_row(peer), want):
            same(a, b, "rank")
    # rank1: ranks decode through the inverse; stale ranks read as absent
    sranks = np.sort(rng.choice(np.arange(1, 1 << 20), k + 4, replace=False)).astype(np.int32)
    svids = rng.permutation(k + 4).astype(np.int32)  # some vids past the maps
    row_ranks = np.where(rng.random((p, n)) < 0.6, rng.choice(sranks, (p, n)),
                         rng.integers(0, 1 << 20, (p, n))).astype(np.int32)
    jt = jax_rank.Rank1Table(jnp.asarray(row_ranks))
    sim = _port_sim("rank1", Rank1Table(torch.from_numpy(row_ranks.copy())), maps,
                    (sranks, svids))
    for peer in range(p):
        want = jax_netsim._peer_row_rank1(
            jt, jnp.int32(peer), jnp.asarray(sranks), jnp.asarray(svids),
            *(jnp.asarray(m) for m in maps))
        for a, b in zip(sim._peer_row(peer), want):
            same(a, b, "rank1")
