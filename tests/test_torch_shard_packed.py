"""The port's packed family on a device mesh against the reference on its
8-device CPU mesh (the counterpart of tests/test_window_frontier_spmd.py
and the packed half of tests/test_shardmap_gossip.py), at nf = 3
(packed), 2 (rank) and 1 (rank1): the route predicates; the per-shard
frontier step (#22 at m = 1 against the reference's Pallas kernel in
interpret mode, #23 at m = 8 against its XLA trapezoid rounds and, for
rank1, its Pallas kernel; the CUDA kernel's pipelined pass at m = 8,
modelled, against the plain version and the reference's kernel or its
rounds on shards of 1 to 256 rows); the window step (#25: the plain version
against the reference's kernel in interpret mode at m = 3 and 5, and
against its distance chain and classic rounds at m = 15 and 63; the CUDA
kernel's design, the distance chain on shared-memory row tiles with
carried halos and an atomic stats reduction, modelled on the same inputs
and on shards of up to 1024 rows); the window fold (#26); the ring,
chain, mesh, star and generic exchanges; the spmd fast_forward window;
gossip_frontier_shardmap_packed in all three modes (cutoffs, a sparse
seed). Tolerance: exact (int32 fields, counts, stats, ids, rounds and
residuals)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from bullet_tpu.ops import packed as ref_pk
from bullet_tpu.ops.rank import Rank1Table as JaxRank1, RankTable as JaxRank
from bullet_tpu.parallel import mesh as ref_mesh
from bullet_tpu.parallel import shardmap_gossip as ref_sg
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch.convert import sharded_from_numpy, table_to_numpy
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.ops.ring_kernel import _round_masks, frontier_tile_n
from bullet_tpu_torch.parallel import shardmap_gossip as sg
from bullet_tpu_torch.parallel import topology as port_topo

from _kernel_models import (
    PipeKey,
    shard_pipe_model,
    shard_sweep_model,
    sweep_unit,
    shard_window_model,
    window_model,
    window_model_launch,
    window_tile_rows,
)

torch.set_num_threads(2)

needs_devices = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
LAYOUT = {3: "packed", 2: "rank", 1: "rank1"}
JAX_TYPE = {3: ref_pk.PackedTable, 2: JaxRank, 1: JaxRank1}


def family(nf, p, n, seed, absent=0.0):
    """nf fields with many ties. Packed: negative keys, and absent (cls 0)
    entries with nonzero keys unless ``absent`` > 0, which makes that share
    of entries all-zero (a sim's absent entries); rank: cv a function of
    the rank, as in a sim."""
    rng = np.random.default_rng(seed)
    if nf == 3:
        cls = rng.integers(0, 4, (p, n))
        vid = rng.integers(0, 5, (p, n))
        fields = [rng.integers(-3, 3, (p, n)), rng.integers(-3, 3, (p, n)), (cls << 28) | vid]
    else:
        rank = rng.integers(0, 6, (p, n))
        fields = [rank, np.where(rank > 0, (1 << 28) | rank, 0)][:nf]
    gone = rng.random((p, n)) < absent
    return [np.where(gone, 0, f).astype(np.int32) for f in fields]


def T(xs):
    return [torch.from_numpy(np.array(x, dtype=np.int32)) for x in xs]


def J(nf, xs):
    return JAX_TYPE[nf](*(jnp.asarray(x) for x in xs))


def jax_sharded(nf, fields, k=8):
    mesh = ref_mesh.make_mesh(k)
    sharding = NamedSharding(mesh, PartitionSpec(ref_mesh.PEER_AXIS, None))
    return JAX_TYPE[nf](*(jax.device_put(jnp.asarray(f), sharding) for f in fields)), mesh


def sharded(nf, fields, k=8):
    return sharded_from_numpy(fields, ("cpu",) * k, LAYOUT[nf])


def assert_equal(port, ref, what=""):
    port = table_to_numpy(port) if not isinstance(port, (list, tuple)) else port
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), what)


def all_ids(t_total, m):
    ids = torch.zeros(t_total + (3 if m > 1 else 2), dtype=torch.int32)
    ids[:t_total] = torch.arange(t_total)
    ids[t_total] = t_total
    return ids


def boundary(nf, s, n, seed, zero):
    return [np.zeros((s, n), np.int32)] * nf if zero else family(nf, s, n, seed)


# ------------------------------------------------------------ predicates


@pytest.mark.parametrize("nf", [3, 2, 1])
def test_route_predicates_match_reference(nf):
    """frontier_available_sharded == frontier_tile_n_sharded > 0, and
    window_frontier_depth == window_frontier_params' m, on every shape
    class: uneven splits, shards under 8 rows or not 8-aligned, n not a
    multiple of 128, and every depth boundary."""
    for p, n, k in ((64, 512, 8), (64, 512, 4), (60, 512, 4), (32, 512, 8), (96, 512, 8),
                    (64, 500, 8), (64, 384, 8), (1024, 1 << 20, 4), (128, 256, 1), (8, 128, 1),
                    (0, 128, 1), (64, 512, 0)):
        want = ref_pk.frontier_tile_n_sharded(p, n, k) > 0
        assert pk.frontier_available_sharded(p, n, k) == want
    for b in (0, 4, 8, 12, 14, 15, 16, 24, 31, 32, 40, 63, 64, 100, 128, 256, 1024):
        for n in (100, 128, 384, 4096, 1 << 20):
            assert pk.window_frontier_depth(b, n) == ref_pk.window_frontier_params(nf, b, n)[0]


# ------------------------------------------- per-shard frontier (#22, #23)


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("zero", ["none", "top", "bottom"])
def test_frontier_shard_m1_matches_reference_kernel(nf, zero):
    """#22: one shard of [8, 512] with 8-row boundary pads (zeroed: a
    chain's end); the reference's kernel reads row 7 of its tops and row 0
    of its bottoms, the port takes that one row; its one stripe's count is
    the sum of the port's two."""
    b, n = 8, 512
    f = family(nf, b, n, 10 + nf)
    tops, bottoms = boundary(nf, 8, n, 20, zero == "top"), boundary(nf, 8, n, 21, zero == "bottom")
    ids = np.array([0, 1, 1], np.int32)
    want, c_want = ref_pk.frontier_shard_round_packed(
        J(nf, f), J(nf, tops), J(nf, bottoms), jnp.asarray(ids), True)
    tile = frontier_tile_n(n)
    got = T(f)
    counts = pk.frontier_shard_round_packed(got, T([x[-1:] for x in tops]),
                                            T([x[:1] for x in bottoms]), all_ids(n // tile, 1),
                                            tile)
    assert_equal(got, want)
    assert int(counts.sum()) == int(np.asarray(c_want).sum())
    assert counts.shape == (1, n // tile)


def _trapezoid_twin(nf, f, tops, bottoms, m):
    """The reference's XLA body of #23: m rounds of _merge_ext_round on the
    extended column [tops | shard | bottoms] (8 rows each way)."""
    ext = [jnp.concatenate([jnp.asarray(t), jnp.asarray(x), jnp.asarray(bo)])
           for x, t, bo in zip(f, tops, bottoms)]
    counts = []
    b = f[0].shape[0]
    for _ in range(m):
        ext, c = ref_pk._merge_ext_round(ext, True, b, b, 0)
        counts.append(int(c))
    return [np.asarray(e[8:8 + b]) for e in ext], counts


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("zero", ["none", "top", "bottom"])
def test_frontier_shard_m8_matches_reference_twin(nf, zero):
    """#23: eight rounds per exchange of 8 boundary rows against the
    reference's trapezoid rounds (XLA), per-round counts summed over the
    port's stripes; rank1 also against the reference's Pallas kernel in
    interpret mode."""
    b, n = 16, 512
    f = family(nf, b, n, 30 + nf, absent=0.5)
    tops = boundary(nf, 8, n, 31, zero == "top")
    bottoms = boundary(nf, 8, n, 32, zero == "bottom")
    want, c_want = _trapezoid_twin(nf, f, tops, bottoms, 8)
    tile = frontier_tile_n(n)
    ids = all_ids(n // tile, 8)
    plain = T(f)
    c_plain = pk.frontier_shard_round_torch(plain, T(tops), T(bottoms), ids, tile,
                                            pk.packed_beats, 8)
    got = T(f)
    counts = pk.frontier_shard_round_packed(got, T(tops), T(bottoms), ids, tile, 8)
    for table, c in ((plain, c_plain), (got, counts)):
        assert_equal(table, want)
        assert c.sum(1).tolist() == c_want
    if nf == 1 and zero == "none":
        ids = np.array([0, 1, 1, 0], np.int32)
        kernel, c_kernel = ref_pk.frontier_shard_multiround_packed(
            J(nf, f), J(nf, tops), J(nf, bottoms), jnp.asarray(ids), True)
        assert_equal(got, kernel)
        assert np.asarray(c_kernel)[:, 0].tolist() == c_want


# a shard's slots and the port's stripes in the model tests: four stripes,
# of which stripes 1 and 3 are the sparse case's active ones
PIPE_N, PIPE_TILE = 512, 128
SPARSE = np.array([False, True, False, True])


@functools.lru_cache(maxsize=None)
def _pipe_case(nf, b, zero, sparse):
    """One shard of [b, PIPE_N] with 11 boundary rows each way (a zeroed
    slab is a chain's end), and what the reference makes of it: eight
    rounds from the 8 boundary rows next to the shard, on the columns of
    the active stripes, by its Pallas kernel in interpret mode where that
    takes the shard (b % 8 == 0), else by its XLA trapezoid rounds
    (``_merge_ext_round``). Returns (fields, tops, bottoms, stripe flags,
    the reference's rows of those columns, its per-round counts)."""
    f = family(nf, b, PIPE_N, 40 + b, absent=0.2)
    tops = boundary(nf, 11, PIPE_N, 41 + b, zero == "top")
    bottoms = boundary(nf, 11, PIPE_N, 42 + b, zero == "bottom")
    flags = SPARSE if sparse else np.ones(len(SPARSE), bool)
    cols = np.repeat(flags, PIPE_TILE)
    sub = [x[:, cols] for x in f]
    top, bottom = [x[-8:, cols] for x in tops], [x[:8, cols] for x in bottoms]
    if b % 8 == 0:
        width = int(cols.sum())
        t_ref = width // ref_pk._stripe_tile_n(b, width)
        ids = np.zeros(t_ref + 3, np.int32)
        ids[:t_ref], ids[t_ref] = np.arange(t_ref), t_ref
        rows, c = ref_pk.frontier_shard_multiround_packed(
            J(nf, sub), J(nf, top), J(nf, bottom), jnp.asarray(ids), True)
        rows, totals = [np.asarray(r) for r in rows], np.asarray(c).sum(1)
    else:
        rows, totals = _trapezoid_twin(nf, sub, top, bottom, 8)
    return f, tops, bottoms, flags, rows, np.asarray(totals)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("zero", ["none", "top", "bottom"])
@pytest.mark.parametrize("s", [8, 11])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 37, 256])
@pytest.mark.parametrize("nf", [3, 2, 1])
def test_shard_pipe_model_matches_reference(nf, b, s, zero, sparse):
    """#23 at m = 8: the CUDA kernel's pipelined pass over the extended
    column (shard_pipe_model) on shards smaller than the pipeline (b = 1,
    3), at its depth (8) and past it, with s = 8 boundary rows or s = 11 >
    m; rows and every per-round, per-stripe count equal the plain
    version's, the active stripes' rows and per-round totals the
    reference's, and inactive stripes stay as they were."""
    f, tops, bottoms, flags, want, totals = _pipe_case(nf, b, zero, sparse)
    top, bottom = T([x[-s:] for x in tops]), T([x[:s] for x in bottoms])
    ids = all_ids(len(flags), 8)
    ids[:int(flags.sum())] = torch.from_numpy(np.flatnonzero(flags))
    ids[len(flags)] = int(flags.sum())
    got, plain = T(f), T(f)
    counts = shard_pipe_model(got, top, bottom, ids, PIPE_TILE, PipeKey(LAYOUT[nf]), 8)
    c_plain = pk.frontier_shard_round_torch(plain, top, bottom, ids, PIPE_TILE,
                                            pk.packed_beats, 8)
    assert all(torch.equal(a, p) for a, p in zip(got, plain))
    assert torch.equal(counts, c_plain)
    cols = np.repeat(flags, PIPE_TILE)
    for a, x, w in zip(got, f, want):
        np.testing.assert_array_equal(a.numpy()[:, cols], w)
        np.testing.assert_array_equal(a.numpy()[:, ~cols], x[:, ~cols])
    assert counts.sum(1).tolist() == totals.tolist()
    assert not counts[:, ~torch.from_numpy(flags)].any()


# ------------------------------ the single round at m = 1 (#22), modelled

BOUNDARY_CASES = tuple(itertools.product(("none", "top", "bottom"), (False, True)))


@functools.lru_cache(maxsize=None)
def _sweep_case(nf, b, zero, sparse):
    """One shard of [b, PIPE_N] with 11 boundary rows each way (a zeroed
    slab is a chain's end), and the reference's round of it on the columns
    of the active stripes, given the 8 boundary rows next to the shard: its
    Pallas kernel in interpret mode where that takes the shard (b % 8 ==
    0; it reads row 7 above and row 0 below), else one round of its XLA
    trapezoid (``_merge_ext_round``). Returns (fields, tops, bottoms,
    stripe flags, the reference's rows of those columns, its count)."""
    f = family(nf, b, PIPE_N, 60 + b, absent=0.2)
    tops = boundary(nf, 11, PIPE_N, 61 + b, zero == "top")
    bottoms = boundary(nf, 11, PIPE_N, 62 + b, zero == "bottom")
    flags = SPARSE if sparse else np.ones(len(SPARSE), bool)
    cols = np.repeat(flags, PIPE_TILE)
    sub = [x[:, cols] for x in f]
    top, bottom = [x[-8:, cols] for x in tops], [x[:8, cols] for x in bottoms]
    if b % 8 == 0:
        width = int(cols.sum())
        t_ref = width // ref_pk._stripe_tile_n(b, width)
        ids = np.zeros(t_ref + 2, np.int32)
        ids[:t_ref], ids[t_ref] = np.arange(t_ref), t_ref
        rows, c = ref_pk.frontier_shard_round_packed(
            J(nf, sub), J(nf, top), J(nf, bottom), jnp.asarray(ids), True)
        rows, total = [np.asarray(r) for r in rows], int(np.asarray(c).sum())
    else:
        rows, c = _trapezoid_twin(nf, sub, top, bottom, 1)
        total = c[0]
    return f, tops, bottoms, flags, rows, total


@pytest.mark.parametrize("s", [1, 11])
@pytest.mark.parametrize("b", [1, 2, 3, 8, 17, 256])
@pytest.mark.parametrize("nf", [3, 2, 1])
def test_shard_sweep_model_matches_reference(nf, b, s):
    """#22 at m = 1: the CUDA kernel's single round (shard_sweep_model: row
    s - 1 above and row 0 below read once, the shard's rows through the
    ring of prefetched rows, units of 2 or 4 columns) on shards of 1 to
    256 rows with s = 1 or 11 boundary rows, random, zeroed-top and
    zeroed-bottom boundaries, all and sparse stripes: rows and per-stripe
    counts equal the plain version's, the active stripes' rows and the
    total the reference's, inactive stripes and the boundary rows stay as
    they were."""
    for zero, sparse in BOUNDARY_CASES:
        f, tops, bottoms, flags, want, total = _sweep_case(nf, b, zero, sparse)
        top, bottom = T([x[-s:] for x in tops]), T([x[:s] for x in bottoms])
        before = [x.clone() for x in (*top, *bottom)]
        ids = all_ids(len(flags), 1)
        ids[:int(flags.sum())] = torch.from_numpy(np.flatnonzero(flags))
        ids[len(flags)] = int(flags.sum())
        got, plain = T(f), T(f)
        counts = shard_sweep_model(got, top, bottom, ids, PIPE_TILE, LAYOUT[nf])
        c_plain = pk.frontier_shard_round_torch(plain, top, bottom, ids, PIPE_TILE,
                                                pk.packed_beats, 1)
        assert all(torch.equal(a, p) for a, p in zip(got, plain))
        assert torch.equal(counts, c_plain)
        cols = np.repeat(flags, PIPE_TILE)
        for a, x, w in zip(got, f, want):
            np.testing.assert_array_equal(a.numpy()[:, cols], w)
            np.testing.assert_array_equal(a.numpy()[:, ~cols], x[:, ~cols])
        assert int(counts.sum()) == total
        assert not counts[:, ~torch.from_numpy(flags)].any()
        assert all(torch.equal(a, x) for a, x in zip((*top, *bottom), before))


@pytest.mark.parametrize("tile", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("nf", [3, 2, 1])
def test_shard_sweep_model_units(nf, tile):
    """The m = 1 kernel's column units at the packed family's field counts:
    the widest unit (2 columns at nf = 3, 4 at nf = 2 and 1) whose units
    fill the stripe in whole warps, so no unit is ragged; narrower stripes
    fall back to 2 or 1 columns. The model at each width against the plain
    version, three stripes, one inactive."""
    units = {32: 1, 64: 2, 96: 1, 128: 2 if nf == 3 else 4, 256: 2 if nf == 3 else 4}
    assert sweep_unit(nf, tile) == units[tile]
    n, b = 3 * tile, 5
    f, top, bottom = (family(nf, rows, n, tile + rows, absent=0.2) for rows in (b, 2, 3))
    ids = all_ids(3, 1)
    ids[:2] = torch.tensor([0, 2])
    ids[3] = 2
    got, plain = T(f), T(f)
    counts = shard_sweep_model(got, T(top), T(bottom), ids, tile, LAYOUT[nf])
    c_plain = pk.frontier_shard_round_torch(plain, T(top), T(bottom), ids, tile,
                                            pk.packed_beats, 1)
    assert all(torch.equal(a, p) for a, p in zip(got, plain))
    assert torch.equal(counts, c_plain) and int(counts.sum()) > 0


def test_frontier_shard_packed_skips_inactive_stripes():
    b, n = 8, 1024
    f = T(family(3, b, n, 1))
    before = [x.clone() for x in f]
    rows = T(family(3, 8, n, 2))
    flags = np.array([False, True, False, True])
    ids = torch.zeros(7, dtype=torch.int32)
    ids[:2] = torch.tensor([1, 3])
    ids[4] = 2
    counts = pk.frontier_shard_round_packed(f, rows, rows, ids, 256, 8)
    assert counts.shape == (8, 4) and not counts[:, ~torch.from_numpy(flags)].any()
    for a, o in zip(f, before):
        assert torch.equal(a[:, :256], o[:, :256]) and torch.equal(a[:, 512:768], o[:, 512:768])


# ---------------------------------------------------- window step (#25)


def _classic_rounds(nf, f, tops, bottoms, tile, m):
    """What the window step computes, as m classic rounds of the extended
    column as a ring: each entry of the shard marked on its first change,
    each stripe's last changed round."""
    b, n = f[0].shape
    ext = [torch.cat([t, x, bo]) for x, t, bo in zip(T(f), T(tops), T(bottoms))]
    marks = torch.zeros((b, n), dtype=torch.bool)
    last = torch.zeros(n // tile, dtype=torch.int32)
    for k in range(1, m + 1):
        ext, gt1, gt2 = _round_masks(ext, True, pk.packed_beats)
        changed = (gt1 | gt2)[m:m + b]
        marks |= changed
        last = torch.where(changed.reshape(b, -1, tile).any(2).any(0), k, last)
    stats = torch.stack([marks.reshape(b, -1, tile).sum((0, 2)).to(torch.int32), last])
    return [e[m:m + b] for e in ext], stats


def _window_model(nf, f, tops, bottoms, ids, tile, m, h_max=None):
    """frontier_shard_window.cu's schedule (tests/_kernel_models.py) at
    the kernel's own row tile, or at ``h_max`` rows (more, smaller tiles)."""
    got = T(f)
    stats = shard_window_model(got, T(tops), T(bottoms), ids, tile, m,
                               h_max or window_tile_rows(nf, f[0].shape[0], m))
    return got, stats


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("zero", ["none", "top"])
def test_frontier_shard_window_matches_reference_kernel(nf, m, zero):
    """#25 at small m: the plain version against the reference's kernel in
    interpret mode (tile 256: one stripe each), block and stats; the
    kernel's sweep design on the same inputs."""
    b, n = 8, 512
    f = family(nf, b, n, 40 + m + nf, absent=0.3)
    tops, bottoms = boundary(nf, m, n, 41, zero == "top"), boundary(nf, m, n, 42, False)
    ids = np.array([0, 1, 2, 0, 0], np.int32)
    want, st_want = ref_pk.frontier_shard_window_packed(
        J(nf, f), J(nf, tops), J(nf, bottoms), jnp.asarray(ids), m, 256, True)
    got = T(f)
    stats = pk.frontier_shard_window(got, T(tops), T(bottoms), all_ids(2, m), 256, m)
    assert_equal(got, want)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(st_want))
    model, st_model = _classic_rounds(nf, f, tops, bottoms, 256, m)
    assert_equal(model, want)
    np.testing.assert_array_equal(st_model.numpy(), np.asarray(st_want))
    # the kernel's design: one tile, and tiles of 2 m + 2 rows
    for h_max in (None, 2 * m + 2):
        model, st_model = _window_model(nf, f, tops, bottoms, all_ids(2, m), 256, m, h_max)
        assert_equal(model, want, f"h_max={h_max}")
        np.testing.assert_array_equal(st_model.numpy(), np.asarray(st_want))


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("m,zero", [(15, "none"), (63, "bottom"), (63, "none")])
def test_frontier_shard_window_deep_matches_classic_rounds(nf, m, zero):
    """#25 at the card's depths: the plain version against the reference's
    distance chain (XLA) on the extended column and against m classic
    rounds (the kernel's design), block and stats, sparse and dense
    stripes."""
    b, n = 64, 512
    f = family(nf, b, n, 50 + nf)
    tops, bottoms = boundary(nf, m, n, 52, False), boundary(nf, m, n, 53, zero == "bottom")
    # stripe 0 settled (all zero), stripe 1 one source at row 32, the rest
    # dense
    for x in (*f, *tops, *bottoms):
        x[:, :256] = 0
    for x in f:
        x[32, 128:256] = x[33, 256:384]
    ext = [jnp.concatenate([jnp.asarray(t), jnp.asarray(x), jnp.asarray(bo)])
           for x, t, bo in zip(f, tops, bottoms)]
    ext, dist = ref_pk._window_dist_chain(ext, jnp.zeros_like(ext[0]), m)
    want = [np.asarray(e[m:m + b]) for e in ext]
    changed = np.asarray(ref_pk._lex_gt_packed(ref_pk.table_keys(tuple(want)),
                                               ref_pk.table_keys(tuple(map(jnp.asarray, f)))))
    tile = 128
    last = np.where(changed, np.asarray(dist)[m:m + b], 0)
    st_want = np.stack([changed.reshape(b, -1, tile).sum((0, 2)),
                        last.reshape(b, -1, tile).max((0, 2))])
    got = T(f)
    stats = pk.frontier_shard_window(got, T(tops), T(bottoms), all_ids(n // tile, m), tile, m)
    assert_equal(got, want)
    np.testing.assert_array_equal(stats.numpy(), st_want)
    model, st_model = _classic_rounds(nf, f, tops, bottoms, tile, m)
    assert_equal(model, want)
    np.testing.assert_array_equal(st_model.numpy(), st_want)
    for h_max in (None, 2 * m + 9):
        model, st_model = _window_model(nf, f, tops, bottoms, all_ids(n // tile, m), tile, m,
                                        h_max)
        assert_equal(model, want, f"h_max={h_max}")
        np.testing.assert_array_equal(st_model.numpy(), st_want)
    assert st_want[1, 0] == 0 and st_want[1, 1] == min(32, m)


def _chain_want(f, tops, bottoms, m, tile, active):
    """The reference's distance chain (XLA) on the extended column: the
    shard's rows and the [2, t_total] window stats, the stripes outside
    ``active`` left as they were with zero stats."""
    b = f[0].shape[0]
    ext = [jnp.concatenate([jnp.asarray(t), jnp.asarray(x), jnp.asarray(bo)])
           for x, t, bo in zip(f, tops, bottoms)]
    ext, dist = ref_pk._window_dist_chain(ext, jnp.zeros_like(ext[0]), m)
    new = [np.asarray(e[m:m + b]) for e in ext]
    changed = np.asarray(ref_pk._lex_gt_packed(ref_pk.table_keys(tuple(map(jnp.asarray, new))),
                                               ref_pk.table_keys(tuple(map(jnp.asarray, f)))))
    last = np.where(changed, np.asarray(dist)[m:m + b], 0)
    on = np.repeat(active, tile)
    want = [np.where(on, x, o) for x, o in zip(new, f)]
    st = np.stack([changed.reshape(b, -1, tile).sum((0, 2)), last.reshape(b, -1, tile).max((0, 2))])
    return want, np.where(active, st, 0)


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("b,m,h_max,zero,dirty", [
    (8, 63, None, "none", "all"), (8, 15, 33, "bottom", "sparse"),
    (37, 15, None, "top", "all"), (37, 31, 70, "none", "sparse"),
    (64, 63, None, "bottom", "sparse"), (64, 15, 31, "none", "all"),
    (1024, 63, None, "none", "all"), (1024, 31, 100, "top", "sparse"),
    (1024, 15, 500, "bottom", "all"),
])
def test_frontier_shard_window_kernel_model_matches_chain(nf, b, m, h_max, zero, dirty):
    """#25 as the card runs it, against the reference's distance chain:
    shards of 8 to 1024 rows, m up to 63, the kernel's own row tile (at
    b = 1024 more than one at every nf) and smaller ones (down to a single
    shard row a tile), each 64-wide stripe split over four 16-column
    blocks whose stats meet in an add and a max, random and zeroed slabs,
    all and sparse stripes; the plain version on the same inputs."""
    n, tile = 256, 64
    t_total = n // tile
    f = family(nf, b, n, b + m + nf, absent=0.5)
    tops = boundary(nf, m, n, 3 * m, zero == "top")
    bottoms = boundary(nf, m, n, 3 * m + 1, zero == "bottom")
    active = np.ones(t_total, bool) if dirty == "all" else np.array([False, True, True, False])
    want, st_want = _chain_want(f, tops, bottoms, m, tile, active)
    ids = torch.from_numpy(np.concatenate([np.flatnonzero(active), [0] * (t_total - active.sum()),
                                           [active.sum(), 0, 0]]).astype(np.int32))
    if h_max is None:
        h_max = window_tile_rows(nf, b, m)
        assert (h_max < b + 2 * m) == (b == 1024)
    got, stats = _window_model(nf, f, tops, bottoms, ids, tile, m, h_max)
    assert_equal(got, want)
    np.testing.assert_array_equal(stats.numpy(), st_want)
    plain = T(f)
    stats = pk.frontier_shard_window(plain, T(tops), T(bottoms), ids, tile, m)
    assert_equal(plain, want)
    np.testing.assert_array_equal(stats.numpy(), st_want)


def test_frontier_shard_window_model_needs_its_carry():
    """The tiles' carried pre-call rows are what keeps them apart: loading
    each tile whole from the shard instead reads the margin rows that the
    tile before wrote, and the rows and stats go wrong."""
    nf, b, m, n, tile = 3, 64, 15, 128, 64
    f = family(nf, b, n, 7, absent=0.5)
    tops, bottoms = boundary(nf, m, n, 8, False), boundary(nf, m, n, 9, False)
    want, st_want = _chain_want(f, tops, bottoms, m, tile, np.ones(2, bool))
    ids = all_ids(2, m)
    for carry_halos in (True, False):
        got = T(f)
        stats = shard_window_model(got, T(tops), T(bottoms), ids, tile, m, 2 * m + 4,
                                   carry_halos=carry_halos)
        same = (all(np.array_equal(a.numpy(), w) for a, w in zip(got, want))
                and np.array_equal(stats.numpy(), st_want))
        assert same == carry_halos


def test_frontier_shard_window_skips_inactive_stripes_and_checks_slabs():
    b, n, m = 16, 512, 5
    f = T(family(2, b, n, 3))
    before = [x.clone() for x in f]
    slab = T(family(2, m, n, 4))
    ids = torch.tensor([2, 0, 0, 0, 1, 0, 0], dtype=torch.int32)
    stats = pk.frontier_shard_window(f, slab, slab, ids, 128, m)
    assert not stats[:, [0, 1, 3]].any() and stats[0, 2] > 0
    for a, o in zip(f, before):
        assert torch.equal(a[:, :256], o[:, :256]) and torch.equal(a[:, 384:], o[:, 384:])
    with pytest.raises(ValueError, match="slabs"):
        pk.frontier_shard_window(f, T(family(2, 8, n, 4)), T(family(2, 8, n, 4)), ids, 128, m)


# --------------------------------------------------------- window fold (#26)


@pytest.mark.parametrize("t_total", [1, 7, 64])
@pytest.mark.parametrize("m", [5, 63])
@pytest.mark.parametrize("kind", ["random", "zero", "at_m"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_compact_counts_window_matches_reference(t_total, m, kind, shards):
    """The fold of S shards' [S, 2, t_total] window stats against the
    reference's window compaction of their numpy agreement (row 0 summed,
    wrapping like its int32 psum; row 1 maxed, its pmax); both zero the
    stats they read."""
    rng = np.random.default_rng(t_total + m + 100 * shards)
    size = (shards, t_total)
    rows = {
        "random": (rng.integers(-5, 1 << 30, size), rng.integers(0, m + 1, size)),
        "zero": (np.zeros(size), np.zeros(size)),
        "at_m": (rng.integers(1, 1 << 30, size), np.full(size, m)),  # sums wrap
    }[kind]
    stats = np.stack(rows, 1).astype(np.int32)
    agreed = np.stack([stats[:, 0].sum(0, dtype=np.int64).astype(np.int32), stats[:, 1].max(0)])
    want = np.asarray(ref_pk.compact_counts_window_packed(jnp.asarray(agreed), m, interpret=True))
    for fn in (pk.compact_counts_window, pk.compact_counts_window_torch):
        shard_stats = torch.tensor(stats)
        got = fn(shard_stats, m).numpy()
        k = int(want[t_total])
        np.testing.assert_array_equal(got[:k], want[:k])  # past the count: unspecified
        np.testing.assert_array_equal(got[t_total:], want[t_total:])
        assert not shard_stats.any()


# ------------------------------------------------------- exchange rounds


@needs_devices
@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("n", [128, 100])  # the per-shard frontier; shifted copies
def test_ring_round_packed_matches_reference(nf, wrap, n):
    t = family(nf, 16, n, nf + wrap)
    tbl, mesh = jax_sharded(nf, t)
    want, c_want = ref_sg.ring_round_shardmap_packed(tbl, mesh, wrap)
    got, c_got = sg.ring_round_shardmap_packed(sharded(nf, t), wrap)
    assert_equal(got, want)
    assert int(c_got) == int(c_want)
    kind = "ring" if wrap else "chain"
    got, c_got = pk.gossip_round_packed(sharded(nf, t), getattr(port_topo, kind)(16))
    assert_equal(got, want)
    assert int(c_got) == int(c_want)


@needs_devices
@pytest.mark.parametrize("nf", [3, 2, 1])
def test_mesh_star_generic_packed_match_reference(nf):
    t = family(nf, 24, 128, 60 + nf)
    tbl, mesh = jax_sharded(nf, t)
    want, c_want = ref_sg.mesh_round_shardmap_packed(tbl, mesh)
    got, c_got = sg.mesh_round_shardmap_packed(sharded(nf, t))
    assert_equal(got, want)
    assert int(c_got) == int(c_want)
    for hub in (0, 13):
        want, c_want = ref_sg.star_round_shardmap_packed(tbl, mesh, hub=hub)
        got, c_got = sg.star_round_shardmap_packed(sharded(nf, t), hub)
        assert_equal(got, want)
        assert int(c_got) == int(c_want)
    nb = np.asarray(jax_topo.random_graph(24, 3, seed=nf).neighbors)
    want, c_want = ref_sg.generic_round_shardmap_packed(tbl, jnp.asarray(nb), mesh)
    got, c_got = sg.generic_round_shardmap_packed(sharded(nf, t), nb)
    assert_equal(got, want)
    assert int(c_got) == int(c_want)


@needs_devices
@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("wrap", [True, False])
def test_ring_window_shardmap_packed_matches_reference(nf, wrap):
    """The spmd fast_forward window: m rounds per exchange of m-row slabs
    (m up to the 8 rows of a shard), state and round-m residual."""
    t = family(nf, 64, 256, 70 + nf, absent=0.7)
    tbl, mesh = jax_sharded(nf, t)
    for m in (1, 3, 8):
        want, c_want = ref_sg.ring_window_shardmap_packed(tbl, mesh, wrap, m)
        got, c_got = sg.ring_window_shardmap_packed(sharded(nf, t), wrap, m)
        assert_equal(got, want, f"m={m}")
        assert int(c_got) == int(c_want)
    with pytest.raises(ValueError):
        sg.ring_window_shardmap_packed(sharded(nf, t), wrap, 9)


def np_beats(nf, b, a):
    """b beats a strictly, in numpy: packed keyed (cls, khi, klo, cv) with
    cls = cv >> 28 (signed), rank and rank1 by the rank."""
    if nf != 3:
        return b[0] > a[0]
    kb, ka = (b[2] >> 28, b[0], b[1], b[2]), (a[2] >> 28, a[0], a[1], a[2])
    gt = np.zeros(a[0].shape, bool)
    eq = np.ones(a[0].shape, bool)
    for x, y in zip(kb, ka):
        gt |= eq & (x > y)
        eq &= x == y
    return gt


def np_shard_rounds(nf, f, tops, bottoms, m):
    """What the spmd window computes on one shard, independently of the
    port: m classic chain rounds of the extended column [tops | f |
    bottoms] (the all-zero entry past its ends, which never reaches the
    center rows within m rounds), the center rows and the last round's
    sum(gt1) + sum(gt2) over them."""
    b = f[0].shape[0]
    ext = [np.concatenate([t, x, bo]).astype(np.int32) for x, t, bo in zip(f, tops, bottoms)]

    def shift(v, k):
        out = np.zeros_like(v)
        if k > 0:
            out[k:] = v[:-k]
        else:
            out[:k] = v[-k:]
        return out

    for _ in range(m):
        up, down = [shift(v, 1) for v in ext], [shift(v, -1) for v in ext]
        gt1 = np_beats(nf, up, ext)
        m1 = [np.where(gt1, u, v) for u, v in zip(up, ext)]
        gt2 = np_beats(nf, down, m1)
        ext = [np.where(gt2, d, v) for d, v in zip(down, m1)]
    count = int(gt1[m:m + b].sum() + gt2[m:m + b].sum())
    return [e[m:m + b] for e in ext], count


SHARD_BS = (1, 3, 8, 17, 256)


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("b", SHARD_BS)
def test_ring_window_shard_matches_classic_rounds(nf, b):
    """The spmd window's per-shard join, ``ring_window_shard_torch`` (the
    plain version), ``ring_window_shard_packed`` on CPU tensors and the
    kernel's schedule (tests/_kernel_models.py window_model, its extended
    form; 37 columns, a ragged last block) against m classic rounds of the
    extended column, exactly: m <= b, random, zeroed and mixed slabs (one
    side zero, or random rows with zeroed ones among them)."""
    n = 37
    for m in sorted({1, 2, 3, max(1, b // 2), b} & set(range(1, b + 1))):
        f = family(nf, b, n, 1000 * b + m, absent=0.3)
        rand = lambda seed: family(nf, m, n, seed)
        mixed = [np.where(np.arange(m)[:, None] % 2 == 0, x, 0).astype(np.int32)
                 for x in rand(m + 7)]
        zero = [np.zeros((m, n), np.int32)] * nf
        for tops, bottoms in ((rand(m), rand(m + 1)), (zero, zero), (rand(m + 2), zero),
                              (zero, rand(m + 3)), (mixed, rand(m + 4))):
            want, c_want = np_shard_rounds(nf, f, tops, bottoms, m)
            out, c_plain = pk.ring_window_shard_torch(T(f), T(tops), T(bottoms), m)
            assert_equal(out, want, f"plain b={b} m={m}")
            assert int(c_plain) == c_want
            got = T(f)
            assert int(pk.ring_window_shard_packed(got, T(tops), T(bottoms), m)) == c_want
            assert_equal(got, want, f"wrapper b={b} m={m}")
            got = T(f)
            assert int(window_model(got, T(tops), T(bottoms), m, 0)) == c_want
            assert_equal(got, want, f"model b={b} m={m}")
            if b + 2 * m > 2 * m + 2:  # as row tiles past a launch's rows
                got = T(f)
                c_tiles = pk.window_row_tiles(got, m, 2 * m + 2, window_model_launch(),
                                              tops=T(tops), bottoms=T(bottoms))
                assert int(c_tiles) == c_want
                assert_equal(got, want, f"tiles b={b} m={m}")


@needs_devices
@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("wrap", [True, False])
def test_ring_window_shardmap_shapes_match_reference(nf, wrap):
    """The spmd window on shards of 1, 3, 17 and 256 rows, through
    ``ring_window_shardmap_packed`` (the plain version on CPU shards) and
    through the kernel's schedule on the same exchanged slabs, against
    the reference's on its 8-device mesh, state and round-m residual."""
    for b, depths in ((1, (1,)), (3, (2, 3)), (17, (1, 9, 17)), (256, (13, 256))):
        t = family(nf, 8 * b, 24, 90 + b, absent=0.5)
        tbl, mesh = jax_sharded(nf, t)
        for m in depths:
            want, c_want = ref_sg.ring_window_shardmap_packed(tbl, mesh, wrap, m)
            got, c_got = sg.ring_window_shardmap_packed(sharded(nf, t), wrap, m)
            assert_equal(got, want, f"b={b} m={m}")
            assert int(c_got) == int(c_want)
            table = sharded(nf, t)
            parts = [tuple(s) for s in table.shards]
            tops, bottoms = sg.boundary_rows(parts, m, wrap, table.mesh)
            total = sum(int(window_model(list(f), top, bottom, m, 0))
                        for f, top, bottom in zip(parts, tops, bottoms))
            assert_equal(table, want, f"model b={b} m={m}")
            assert (total - int(c_want)) % (1 << 32) == 0


# ------------------------------------------------ the sharded frontier


def classic(nf, fields, wrap, max_rounds):
    """The reference's unsharded classic loop: (fields, rounds, residual)."""
    kind = "ring" if wrap else "chain"
    p = fields[0].shape[0]
    nb = jnp.asarray(getattr(jax_topo, kind)(p).neighbors)
    got, r, c = ref_pk.gossip_until_converged_packed(J(nf, fields), nb, kind, max_rounds)
    return [np.asarray(x) for x in got], int(r), int(c)


@pytest.fixture(scope="module")
def spmd_reference():
    """The reference's gossip_frontier_shardmap_packed in interpret mode on
    its 8-device mesh, single-round and window m = 3, packed ring and chain,
    cut off at 11 rounds: {(wrap, window): (table, rounds, last_changed)}."""
    out = {}
    t = family(3, 64, 256, 80, absent=0.9)
    for wrap in (True, False):
        for window in (0, 3):
            tbl, mesh = jax_sharded(3, t)
            got, r, c = ref_sg.gossip_frontier_shardmap_packed(
                tbl, jnp.ones(2 if window else 1, bool), mesh, wrap, 11, interpret=True,
                window_fuse=window,
                window_tile=128 if window else 0)
            out[wrap, window] = ([np.asarray(f) for f in got], int(r), int(c))
    return t, out


MODES = [dict(fuse=1), dict(fuse=sg.HALO_FUSE), dict(window_fuse=3), dict(window_fuse=8)]


@needs_devices
@pytest.mark.parametrize("wrap", [True, False])
def test_frontier_shardmap_packed_matches_reference_loops(spmd_reference, wrap):
    """The reference's spmd loops (single-round and window) cut off at 11
    rounds: every mode of the port lands on their state, rounds and
    residual."""
    t, ref = spmd_reference
    for window in (0, 3):
        want, r_want, c_want = ref[wrap, window]
        for mode in MODES:
            table = sharded(3, t)
            got, r_got, c_got = sg.gossip_frontier_shardmap_packed(
                table, torch.ones(1, dtype=torch.bool), wrap, 11, **mode)
            assert_equal(got, want, str(mode))
            assert (r_got, c_got) == (r_want, c_want), mode


@needs_devices
@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("max_rounds", [1, 3, 7, 11, 14, 66])
def test_frontier_shardmap_packed_matches_classic_loop(nf, wrap, max_rounds):
    """8 shards of 8 rows, every mode against the unsharded classic loop:
    converging (66 > P + 1) or cut off anywhere (inside a fused step, in
    the tail), state, classic rounds and last-round residual."""
    t = family(nf, 64, 512, 90 + nf, absent=0.9)
    want, r_want, c_want = classic(nf, t, wrap, max_rounds)
    tile = frontier_tile_n(512)
    for mode in MODES:
        got, r_got, c_got = sg.gossip_frontier_shardmap_packed(
            sharded(nf, t), torch.ones(512 // tile, dtype=torch.bool), wrap, max_rounds, **mode)
        assert_equal(got, want, str(mode))
        assert (r_got, c_got) == (r_want, c_want), mode


@needs_devices
@pytest.mark.parametrize("mode", MODES)
def test_frontier_shardmap_packed_sparse_seed_and_empty(mode):
    """From a converged table, one changed entry and its one seeded stripe
    land on the classic loop from the whole table; an empty seed runs
    nothing."""
    p, n = 64, 512
    tile = frontier_tile_n(n)
    base, _, _ = classic(3, family(3, p, n, 83, absent=0.95), True, p + 2)
    upd = [np.array(f) for f in base]
    upd[2][3, tile + 9] = (2 << 28) | 77
    upd[0][3, tile + 9] = 10**9
    want, r_want, _ = classic(3, upd, True, p + 2)
    dirty = torch.zeros(n // tile, dtype=torch.bool)
    dirty[1] = True
    got, rounds, changed = sg.gossip_frontier_shardmap_packed(sharded(3, upd), dirty, True,
                                                             p + 2, **mode)
    assert_equal(got, want)
    assert (rounds, changed) == (r_want, 0)
    got, rounds, changed = sg.gossip_frontier_shardmap_packed(
        sharded(3, upd), torch.zeros(n // tile, dtype=torch.bool), True, p + 2, **mode)
    assert (rounds, changed) == (0, 0)
    assert_equal(got, upd)


@pytest.mark.parametrize("mode", MODES)
def test_frontier_shardmap_folds_once_a_step(monkeypatch, mode):
    """A mesh step's shards write their counts (a window's stats) into
    their rows of one buffer (``out=``), and one fold a step reads that
    buffer's S rows and writes the next ids array into one of two buffers
    in turn, never the array the step read; the loop's result is the
    classic loop's."""
    nf, p, n = 3, 64, 512
    t = family(nf, p, n, 91, absent=0.9)
    want, r_want, c_want = classic(nf, t, True, 30)
    folds, shard_outs = [], []

    def spy_fold(fold):
        def run(rows, *args):
            folds.append((tuple(rows.shape), rows.data_ptr(), args[-1].data_ptr()))
            return fold(rows, *args)
        return run

    def spy_step(step):
        def run(f, top, bottom, ids, tile, m, out=None):
            shard_outs.append((out.data_ptr(), ids.data_ptr()))
            return step(f, top, bottom, ids, tile, m, out=out)
        return run

    monkeypatch.setattr(sg, "compact_counts", spy_fold(sg.compact_counts))
    monkeypatch.setattr(sg, "compact_counts_window", spy_fold(sg.compact_counts_window))
    monkeypatch.setattr(sg, "frontier_shard_round_packed", spy_step(pk.frontier_shard_round_packed))
    monkeypatch.setattr(sg, "frontier_shard_window", spy_step(pk.frontier_shard_window))
    tile = frontier_tile_n(n)
    got, rounds, changed = sg.gossip_frontier_shardmap_packed(
        sharded(nf, t, k=4), torch.ones(n // tile, dtype=torch.bool), True, 30, **mode)
    assert_equal(got, want, str(mode))
    assert (rounds, changed) == (r_want, c_want)
    assert folds and len(shard_outs) == 4 * len(folds)
    read = None
    for i, (shape, rows, ids_out) in enumerate(folds):
        assert shape[0] == 4 and shape[2] == n // tile
        step = shard_outs[4 * i: 4 * i + 4]
        row_bytes = 4 * shape[1] * shape[2]
        assert [o for o, _ in step] == [rows + k * row_bytes for k in range(4)]
        assert {ids for _, ids in step} != {ids_out}
        if read is not None:
            assert {ids for _, ids in step} == {read}
        read = ids_out
    assert len({ids_out for _, _, ids_out in folds}) == min(2, len(folds))


def test_frontier_shardmap_packed_rejects_bad_depths():
    table = sharded(1, family(1, 64, 256, 1))
    seed = torch.ones(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="exclude"):
        sg.gossip_frontier_shardmap_packed(table, seed, True, 9, fuse=8, window_fuse=5)
    with pytest.raises(ValueError, match="rows per shard"):
        sg.gossip_frontier_shardmap_packed(table, seed, True, 99, window_fuse=15)


@needs_devices
def test_reconcile_shardmap_packed_matches_reference():
    for nf in (3, 2, 1):
        t = family(nf, 64, 200, 5 + nf)
        want = ref_pk.reconcile_packed_xla(J(nf, t))
        got = sg.reconcile_shardmap_packed(sharded(nf, t))
        assert_equal(got, want)
