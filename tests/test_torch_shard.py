"""The port's mesh, exchange rounds and sharded dense frontier against the
reference on its 8-device CPU mesh (the counterpart of
tests/test_shardmap_gossip.py): the mesh helpers; ring, chain, mesh, star
and generic rounds on a sharded table; the per-shard frontier step (#6,
#7) and the count compaction (#21, #24) against the reference's Pallas
kernels in interpret mode, and the CUDA kernel's pipelined pass at m = 8
(modelled in tests/_kernel_models.py) against them and the plain version
on shards of 1 to 256 rows; gossip_frontier_shardmap_dense (reference,
lww, lean; ring and chain; fuse 1 and 8; cutoffs; a sparse seed).
Tolerance: exact (int32 fields, counts, ids, rounds and residuals)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from bullet_tpu.ops import packed as ref_pk
from bullet_tpu.ops import ring_kernel as ref_rk
from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.parallel import mesh as ref_mesh
from bullet_tpu.parallel import shardmap_gossip as ref_sg
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu.parallel.gossip import (
    gossip_round_generic,
    gossip_round_mesh,
    gossip_until_converged_device,
)
from bullet_tpu_torch.convert import sharded_from_numpy, table_from_numpy, table_to_numpy
from bullet_tpu_torch.ops.packed import (
    compact_counts,
    compact_counts_torch,
    frontier_shard_round_packed,
    packed_beats,
)
from bullet_tpu_torch.ops.ring_kernel import (
    beats_of,
    frontier_shard_round,
    frontier_shard_round_torch,
    frontier_tile_n,
    ring_round_lean_torch,
)
from bullet_tpu_torch.parallel import mesh as port_mesh
from bullet_tpu_torch.parallel import shardmap_gossip as sg
from bullet_tpu_torch.parallel import topology as topo

from _kernel_models import PipeKey, shard_pipe_model, shard_sweep_model, sweep_unit

torch.set_num_threads(2)

needs_devices = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
MESH = ("cpu",) * 8


def random_fields(p, n, seed=0):
    """Sim-realistic: absent entries (cls = 0) carry all-zero fields."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, (p, n)).astype(np.int32)
    ranges = ((-50, 50), (-50, 50), (0, 30), (0, p), (0, 9), (0, 5))
    rest = [np.where(cls > 0, rng.integers(lo, hi, (p, n)), 0).astype(np.int32)
            for lo, hi in ranges]
    return [cls, *rest]


def sparse_fields(p, n, seed):
    """Absent-heavy: rounds keep changing for about diameter rounds."""
    rng = np.random.default_rng(seed)
    cls = ((rng.random((p, n)) < 0.05) * rng.integers(1, 4, (p, n))).astype(np.int32)
    ranges = ((-50, 50), (-50, 50), (0, 30), (0, p), (0, 9), (0, 5))
    rest = [np.where(cls > 0, rng.integers(lo, hi, (p, n)), 0).astype(np.int32)
            for lo, hi in ranges]
    return [cls, *rest]


def sharded(fields, k=8):
    return sharded_from_numpy(fields, ("cpu",) * k)


def assert_fields_equal(port, ref, what=""):
    for name, a, b in zip(("cls", "khi", "klo", "vid", "writer", "ctr", "tick"),
                          table_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b), f"{name} {what}")


def jax_sharded(fields, k=8):
    mesh = ref_mesh.make_mesh(k)
    sharding = NamedSharding(mesh, PartitionSpec(ref_mesh.PEER_AXIS, None))
    return JaxTable(*(jax.device_put(jnp.asarray(f), sharding) for f in fields)), mesh


# ---------------------------------------------------------- mesh helpers


@needs_devices
@pytest.mark.parametrize("k,p", [(1, 5), (4, 16), (8, 11), (8, 64), (3, 7)])
def test_mesh_helpers(k, p):
    mesh = port_mesh.make_mesh(k, "cpu")
    assert mesh == (torch.device("cpu"),) * k
    assert port_mesh.resolve_mesh(k, "cpu") == port_mesh.resolve_mesh(["cpu"] * k, "cuda")
    if k in (1, 4, 8):
        assert port_mesh.pad_peers_to_mesh(p, mesh) == ref_mesh.pad_peers_to_mesh(
            p, ref_mesh.make_mesh(k))
    p = port_mesh.pad_peers_to_mesh(p, mesh)
    fields = random_fields(p, 40, seed=p)
    table = sharded_from_numpy(fields, mesh)
    assert table.shape == (p, 40) and table.rows == p // k
    assert_fields_equal(table, fields)
    rng = np.random.default_rng(k)
    peers, slots = rng.integers(0, p, 30), rng.integers(0, 40, 30)
    cls, vid = table.gather(peers, slots, (0, 3))
    np.testing.assert_array_equal(cls, fields[0][peers, slots])
    np.testing.assert_array_equal(vid, fields[3][peers, slots])
    rows = table.take_rows(peers, "cpu")
    for a, f in zip(rows, fields):
        np.testing.assert_array_equal(a.numpy(), f[peers])
    new = [torch.full((3, 40), 7 + i, dtype=torch.int32) for i in range(7)]
    table.put_rows([0, p - 1, p // 2], new)
    for i, f in enumerate(fields):
        f[[0, p - 1, p // 2]] = 7 + i
    assert_fields_equal(table, fields)
    whole = table_from_numpy(fields, "cpu")
    assert_fields_equal(port_mesh.shard_table(whole, mesh), fields)


def test_make_mesh_never_shrinks():
    with pytest.raises(ValueError, match="visible"):
        port_mesh.make_mesh(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError):
        port_mesh.make_mesh(0, "cpu")


# ------------------------------------------------------- exchange rounds


@needs_devices
@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("k", [8, 2])
@pytest.mark.parametrize("n", [128, 100])  # the per-shard frontier; shifted copies
def test_ring_round_matches_reference(n, k, wrap, mode):
    t = random_fields(16, n, seed=k + wrap)
    tbl, mesh = jax_sharded(t, k)
    want, c_want = ref_sg.ring_round_shardmap(tbl, mesh, mode=mode, wrap=wrap)
    got, c_got = sg.ring_round_shardmap(sharded(t, k), mode, wrap)
    assert_fields_equal(got, want)
    assert int(c_got) == int(c_want)


@needs_devices
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("n", [128, 100])  # the per-shard frontier; shifted copies
def test_lean_ring_round_matches_reference(n, wrap):
    """A data mesh's lean round: the reference's lean kernel on the whole
    table, interpret mode, where it takes the shape (n % 128 == 0); else
    the port's plain lean round, itself held against that kernel in
    test_torch_lean.py."""
    t = random_fields(16, n, seed=3)
    if n % 128 == 0:
        want, c_want = ref_rk.ring_round_pallas_lean(
            JaxTable(*(jnp.asarray(f) for f in t)), wrap=wrap, interpret=True)
    else:
        want, c_want = ring_round_lean_torch(table_from_numpy(t, "cpu"), wrap)
    got, c_got = sg.ring_round_shardmap(sharded(t), "reference", wrap, lean=True)
    assert_fields_equal(got, want)
    assert int(c_got) == int(c_want)


@needs_devices
def test_chain_edges_do_not_wrap():
    t = [np.zeros((16, 128), np.int32) for _ in range(7)]
    t[0][15, 0], t[3][15, 0], t[1][15, 0] = 2, 9, 5
    out, _ = sg.ring_round_shardmap(sharded(t), wrap=False)
    assert int(out.shards[0].vid[0, 0]) == 0
    out, _ = sg.ring_round_shardmap(sharded(t), wrap=True)
    assert int(out.shards[0].vid[0, 0]) == 9


@needs_devices
@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("k", [8, 4])
def test_mesh_round_matches_reference(k, mode):
    t = random_fields(24, 128, seed=5)
    want, c_want = gossip_round_mesh(JaxTable(*(jnp.asarray(f) for f in t)), mode)
    got, c_got = sg.mesh_round_shardmap(sharded(t, k), mode)
    assert_fields_equal(got, want)
    assert int(c_got) == int(c_want)
    if k == 8:
        tbl, mesh = jax_sharded(t, k)
        want, c_sm = ref_sg.mesh_round_shardmap(tbl, mesh, mode=mode)
        assert int(c_sm) == int(c_got)


@needs_devices
@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("hub", [0, 5, 15])
def test_star_round_matches_reference(mode, hub):
    t = random_fields(16, 128, seed=7 + hub)
    tbl, mesh = jax_sharded(t)
    want, c_want = ref_sg.star_round_shardmap(tbl, mesh, mode=mode, hub=hub)
    got, c_got = sg.star_round_shardmap(sharded(t), mode, hub)
    assert_fields_equal(got, want)
    assert int(c_got) == int(c_want)
    generic, c_gen = gossip_round_generic(
        JaxTable(*(jnp.asarray(f) for f in t)), jnp.asarray(jax_topo.star(16, hub=hub).neighbors),
        mode)
    assert_fields_equal(got, generic)
    assert (int(c_got) > 0) == (int(c_gen) > 0)


@needs_devices
@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("make_topo", [
    lambda t: t.bridge((3, 4), 1),
    lambda t: t.random_graph(16, 3, seed=11),
    lambda t: t.ring(16).drop_links([(3, 4)]),
])
def test_generic_round_matches_reference(mode, make_topo):
    t_opo = make_topo(jax_topo)
    p = t_opo.num_peers
    pad = -p % 8  # pad rows to the mesh like the sim does
    neighbors = np.full((p + pad, t_opo.neighbors.shape[1]), -1, dtype=np.int32)
    neighbors[:p] = t_opo.neighbors
    np.testing.assert_array_equal(make_topo(topo).neighbors, t_opo.neighbors)
    t = random_fields(p + pad, 128, seed=13)
    tbl, mesh = jax_sharded(t)
    nb = jnp.asarray(neighbors)
    want, c_want = ref_sg.generic_round_shardmap(tbl, nb, mesh, mode=mode)
    got, c_got = sg.generic_round_shardmap(sharded(t), neighbors, mode)
    assert_fields_equal(got, want)
    assert int(c_got) == int(c_want)


# ------------------------------------------- per-shard frontier (#6, #7)


def _ids(flags, m):
    t_total = len(flags)
    ids = np.zeros(t_total + (3 if m > 1 else 2), np.int32)
    k = int(flags.sum())
    ids[:k] = np.flatnonzero(flags)
    ids[t_total] = k
    ids[t_total + 1] = 1
    return ids


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mode,lean", [("reference", False), ("lww", False), ("reference", True)])
@pytest.mark.parametrize("zero", ["none", "top", "bottom"])
def test_frontier_shard_matches_reference_kernel(m, mode, lean, zero):
    """One shard of [8, 512] with 8-row boundary snapshots (a zeroed one is
    a chain's end): the port's step on its own stripes (2 of 256) against
    the reference's kernel in interpret mode (one stripe of 512), whose
    counts are the sums of the port's. m = 1 takes the snapshots' row 7
    above and row 0 below, as the reference's kernel does."""
    b, n = 8, 512
    nf = 4 if lean else 7
    f = random_fields(b, n, seed=m + nf)[:nf]
    rng = np.random.default_rng(m)
    tops = [rng.integers(0, 4, (8, n)).astype(np.int32) for _ in range(nf)]
    bottoms = [rng.integers(0, 4, (8, n)).astype(np.int32) for _ in range(nf)]
    if zero == "top":
        tops = [np.zeros_like(x) for x in tops]
    if zero == "bottom":
        bottoms = [np.zeros_like(x) for x in bottoms]
    ref_fn = ref_rk.frontier_shard_round_dense if m == 1 else ref_rk.frontier_shard_multiround_dense
    want, c_want = ref_fn(tuple(map(jnp.asarray, f)), tuple(map(jnp.asarray, tops)),
                          tuple(map(jnp.asarray, bottoms)), jnp.asarray(_ids(np.ones(1, bool), m)),
                          mode, True)
    tile = frontier_tile_n(n)
    ids = torch.from_numpy(_ids(np.ones(n // tile, bool), m))
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    top_rows = [x[-m:] for x in tops] if m == 1 else tops
    bottom_rows = [x[:m] for x in bottoms] if m == 1 else bottoms
    for fn in (frontier_shard_round, frontier_shard_round_torch):
        got = t(f)
        extra = (mode,) if fn is frontier_shard_round else (beats_of(nf, mode),)
        counts = fn(got, t(top_rows), t(bottom_rows), ids, tile, *extra, m)
        for a, e in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(e))
        c_want = np.asarray(c_want).reshape(m, 1)
        np.testing.assert_array_equal(counts.numpy().sum(1, keepdims=True), c_want)


def test_frontier_shard_skips_inactive_stripes():
    b, n = 8, 1024
    f = [torch.from_numpy(x) for x in random_fields(b, n, seed=1)]
    before = [x.clone() for x in f]
    rows = [torch.from_numpy(x) for x in random_fields(8, n, seed=2)]
    flags = np.array([False, True, False, True])
    counts = frontier_shard_round(f, rows, rows, torch.from_numpy(_ids(flags, 8)), 256,
                                  "reference", 8)
    assert counts.shape == (8, 4) and not counts[:, ~torch.from_numpy(flags)].any()
    for a, o in zip(f, before):
        assert torch.equal(a[:, :256], o[:, :256]) and torch.equal(a[:, 512:768], o[:, 512:768])


# ------------------------------ the pipelined pass at m = 8 (#7), modelled

# a shard's slots and the port's stripes in the model tests: four stripes,
# of which stripes 1 and 3 are the sparse case's active ones
PIPE_N, PIPE_TILE = 512, 128
SPARSE = np.array([False, True, False, True])
PIPE_ROWS = (1, 3, 8, 17, 37, 256)


def tied_fields(p, n, rng, nf=7):
    """Dense fields with many ties: small value ranges, negative khi/klo,
    absent (cls = 0) entries with nonzero fields."""
    ranges = ((0, 4), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 4), (0, 5))
    return [rng.integers(lo, hi, (p, n)).astype(np.int32) for lo, hi in ranges[:nf]]


@functools.lru_cache(maxsize=None)
def _pipe_case(mode, lean, b, zero, sparse):
    """One shard of [b, PIPE_N] with 11 boundary rows each way (a zeroed
    slab is a chain's end), and what the reference makes of it: eight
    rounds from the 8 boundary rows next to the shard, on the columns of
    the active stripes, by its Pallas kernel in interpret mode where that
    takes the shard (b % 8 == 0), else by the XLA rounds the kernel runs
    (``_merge_ext_round_dense``). Returns (fields, tops, bottoms, stripe
    flags, the reference's rows of those columns, its per-round counts)."""
    nf = 4 if lean else 7
    rng = np.random.default_rng(b)
    f = tied_fields(b, PIPE_N, rng, nf)
    tops, bottoms = tied_fields(11, PIPE_N, rng, nf), tied_fields(11, PIPE_N, rng, nf)
    if zero == "top":
        tops = [np.zeros_like(x) for x in tops]
    if zero == "bottom":
        bottoms = [np.zeros_like(x) for x in bottoms]
    flags = SPARSE if sparse else np.ones(len(SPARSE), bool)
    cols = np.repeat(flags, PIPE_TILE)
    sub, top, bottom = ([jnp.asarray(x[rows][:, cols]) for x in xs] for xs, rows in (
        (f, slice(None)), (tops, slice(-8, None)), (bottoms, slice(0, 8))))
    if b % 8 == 0:
        tile = ref_rk.frontier_tile_n_dense(b, int(cols.sum()), lean)
        rows, c = ref_rk.frontier_shard_multiround_dense(
            tuple(sub), tuple(top), tuple(bottom),
            jnp.asarray(_ids(np.ones(int(cols.sum()) // tile, bool), 8)), mode, True)
        totals = np.asarray(c).sum(1)
    else:
        ext = [jnp.concatenate([t, x, bo]) for x, t, bo in zip(sub, top, bottom)]
        totals = []
        for _ in range(8):
            ext, c = ref_rk._merge_ext_round_dense(ext, nf, mode, b)
            totals.append(int(c))
        rows = [e[8:8 + b] for e in ext]
    return f, tops, bottoms, flags, [np.asarray(r) for r in rows], np.asarray(totals)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("zero", ["none", "top", "bottom"])
@pytest.mark.parametrize("s", [8, 11])
@pytest.mark.parametrize("b", PIPE_ROWS)
@pytest.mark.parametrize("mode,lean", [("reference", False), ("lww", False), ("reference", True)])
def test_shard_pipe_model_matches_reference(mode, lean, b, s, zero, sparse):
    """#7 at m = 8: the CUDA kernel's pipelined pass over the extended
    column (shard_pipe_model) on shards smaller than the pipeline (b = 1,
    3), at its depth (8) and past it, with s = 8 boundary rows or s = 11 >
    m; rows and every per-round, per-stripe count equal the plain
    version's, the active stripes' rows and per-round totals the
    reference's, and inactive stripes stay as they were."""
    f, tops, bottoms, flags, want, totals = _pipe_case(mode, lean, b, zero, sparse)
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    top, bottom = t([x[-s:] for x in tops]), t([x[:s] for x in bottoms])
    ids = torch.from_numpy(_ids(flags, 8))
    got, plain = t(f), t(f)
    counts = shard_pipe_model(got, top, bottom, ids, PIPE_TILE,
                              PipeKey("lean" if lean else mode), 8)
    c_plain = frontier_shard_round_torch(plain, top, bottom, ids, PIPE_TILE,
                                         beats_of(len(f), mode), 8)
    assert all(torch.equal(a, p) for a, p in zip(got, plain))
    assert torch.equal(counts, c_plain)
    cols = np.repeat(flags, PIPE_TILE)
    for a, x, w in zip(got, f, want):
        np.testing.assert_array_equal(a.numpy()[:, cols], w)
        np.testing.assert_array_equal(a.numpy()[:, ~cols], x[:, ~cols])
    assert counts.sum(1).tolist() == totals.tolist()
    assert not counts[:, ~torch.from_numpy(flags)].any()


# ------------------------------ the single round at m = 1 (#6), modelled

SWEEP_ROWS = (1, 2, 3, 8, 17, 256)
BOUNDARY_CASES = tuple(itertools.product(("none", "top", "bottom"), (False, True)))


@functools.lru_cache(maxsize=None)
def _sweep_case(mode, lean, b, zero, sparse):
    """One shard of [b, PIPE_N] with 11 boundary rows each way (a zeroed
    slab is a chain's end), and the reference's round of it on the columns
    of the active stripes, given the 8 boundary rows next to the shard: its
    Pallas kernel in interpret mode where that takes the shard (b % 8 ==
    0; it reads row 7 above and row 0 below), else one XLA round of the
    extended column (``_merge_ext_round_dense``). Returns (fields, tops,
    bottoms, stripe flags, the reference's rows of those columns, its
    count)."""
    nf = 4 if lean else 7
    rng = np.random.default_rng(100 + b)
    f = tied_fields(b, PIPE_N, rng, nf)
    tops, bottoms = tied_fields(11, PIPE_N, rng, nf), tied_fields(11, PIPE_N, rng, nf)
    if zero == "top":
        tops = [np.zeros_like(x) for x in tops]
    if zero == "bottom":
        bottoms = [np.zeros_like(x) for x in bottoms]
    flags = SPARSE if sparse else np.ones(len(SPARSE), bool)
    cols = np.repeat(flags, PIPE_TILE)
    sub, top, bottom = ([jnp.asarray(x[rows][:, cols]) for x in xs] for xs, rows in (
        (f, slice(None)), (tops, slice(-8, None)), (bottoms, slice(0, 8))))
    if b % 8 == 0:
        tile = ref_rk.frontier_tile_n_dense(b, int(cols.sum()), lean)
        rows, c = ref_rk.frontier_shard_round_dense(
            tuple(sub), tuple(top), tuple(bottom),
            jnp.asarray(_ids(np.ones(int(cols.sum()) // tile, bool), 1)), mode, True)
        total = int(np.asarray(c).sum())
    else:
        ext = [jnp.concatenate([t, x, bo]) for x, t, bo in zip(sub, top, bottom)]
        ext, c = ref_rk._merge_ext_round_dense(ext, nf, mode, b)
        rows, total = [e[8:8 + b] for e in ext], int(c)
    return f, tops, bottoms, flags, [np.asarray(r) for r in rows], total


@pytest.mark.parametrize("s", [1, 11])
@pytest.mark.parametrize("b", SWEEP_ROWS)
@pytest.mark.parametrize("mode,lean", [("reference", False), ("lww", False), ("reference", True)])
def test_shard_sweep_model_matches_reference(mode, lean, b, s):
    """#6 at m = 1: the CUDA kernel's single round (shard_sweep_model: row
    s - 1 above and row 0 below read once, the shard's rows through the
    ring of prefetched rows, units of columns) on shards of 1 to 256 rows
    with s = 1 or 11 boundary rows, random, zeroed-top and zeroed-bottom
    boundaries, all and sparse stripes: rows and per-stripe counts equal
    the plain version's, the active stripes' rows and the total the
    reference's, inactive stripes and the boundary rows stay as they
    were."""
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    for zero, sparse in BOUNDARY_CASES:
        f, tops, bottoms, flags, want, total = _sweep_case(mode, lean, b, zero, sparse)
        top, bottom = t([x[-s:] for x in tops]), t([x[:s] for x in bottoms])
        before = [x.clone() for x in (*top, *bottom)]
        ids = torch.from_numpy(_ids(flags, 1))
        got, plain = t(f), t(f)
        counts = shard_sweep_model(got, top, bottom, ids, PIPE_TILE, "lean" if lean else mode)
        c_plain = frontier_shard_round_torch(plain, top, bottom, ids, PIPE_TILE,
                                             beats_of(len(f), mode), 1)
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
@pytest.mark.parametrize("mode,lean", [("reference", False), ("lww", False), ("reference", True)])
def test_shard_sweep_model_units(mode, lean, tile):
    """The m = 1 kernel's column units: a thread takes the widest unit
    (at most 1 column at nf = 7, 2 at nf = 4) whose units fill the stripe
    in whole warps, so no unit is ragged; stripes whose width does not fit
    the widest unit (96, 32) fall back to single columns. The model at
    each width against the plain version, three stripes, one inactive."""
    nf = 4 if lean else 7
    assert sweep_unit(nf, tile) == (2 if lean and tile % 64 == 0 else 1)
    rng = np.random.default_rng(tile)
    n, b = 3 * tile, 5
    f, top, bottom = (tied_fields(rows, n, rng, nf) for rows in (b, 2, 2))
    t = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    ids = torch.from_numpy(_ids(np.array([True, False, True]), 1))
    got, plain = t(f), t(f)
    counts = shard_sweep_model(got, t(top), t(bottom), ids, tile, "lean" if lean else mode)
    c_plain = frontier_shard_round_torch(plain, t(top), t(bottom), ids, tile,
                                         beats_of(nf, mode), 1)
    assert all(torch.equal(a, p) for a, p in zip(got, plain))
    assert torch.equal(counts, c_plain) and int(counts.sum()) > 0


@pytest.mark.parametrize("layout", ["reference", "lww", "lean", "packed", "rank", "rank1"])
def test_frontier_shard_leaves_the_boundary_rows_unwritten(layout):
    """The boundary rows are read only at the loops' depths: the kernel's
    pass at m = 8 (modelled) and the wrappers at m = 1 and 8 leave the
    neighbours' rows as they were, on a ring's slabs and a chain's zeroed
    one."""
    rng = np.random.default_rng(5)
    if layout in ("packed", "rank", "rank1"):
        nf = {"packed": 3, "rank": 2, "rank1": 1}[layout]
        fields = [rng.integers(-3, 3, (24, PIPE_N)) for _ in range(nf)]
        if nf < 3:  # rank, rank1: keyed by rank, cv a function of it
            fields = [fields[0], np.where(fields[0] > 0, (1 << 28) | fields[0], 0)][:nf]
        step = lambda f, t, bo, ids, m: frontier_shard_round_packed(  # noqa: E731
            f, t, bo, ids, PIPE_TILE, m)
        beats = packed_beats
    else:
        nf = 4 if layout == "lean" else 7
        fields = tied_fields(24, PIPE_N, rng, nf)
        mode = "lww" if layout == "lww" else "reference"
        step = lambda f, t, bo, ids, m: frontier_shard_round(  # noqa: E731
            f, t, bo, ids, PIPE_TILE, mode, m)
        beats = beats_of(nf, mode)
    t = lambda xs: [torch.from_numpy(np.asarray(x, np.int32).copy()) for x in xs]  # noqa: E731
    tops = t(x[:8] for x in fields)
    bottoms = [torch.zeros_like(x) for x in tops]
    shard = t(x[8:] for x in fields)
    before = [x.clone() for x in (*tops, *bottoms)]
    ids = torch.from_numpy(_ids(np.ones(PIPE_N // PIPE_TILE, bool), 8))
    modelled, plain = [x.clone() for x in shard], [x.clone() for x in shard]
    counts = shard_pipe_model(modelled, tops, bottoms, ids, PIPE_TILE, PipeKey(layout), 8)
    assert torch.equal(counts, frontier_shard_round_torch(plain, tops, bottoms, ids, PIPE_TILE,
                                                          beats, 8))
    assert int(counts.sum()) > 0
    for m in (1, 8):
        step([x.clone() for x in shard], tops, bottoms, ids if m == 8 else ids[:-1], m)
    assert all(torch.equal(a, x) for a, x in zip((*tops, *bottoms), before))


# -------------------------------------------- count compaction (#21, #24)


@pytest.mark.parametrize("t_total", [1, 7, 64])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("kind", ["random", "zero", "dirty"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_compact_counts_matches_reference(t_total, m, kind, shards):
    """The fold of S shards' [S, m, t_total] counts and its compaction
    against the reference's compaction of the numpy sum of the shards'
    rows (wrapping like its int32 psum); both zero the counts they read."""
    rng = np.random.default_rng(t_total + m + 100 * shards)
    size = (shards, m, t_total)
    counts = {
        "random": rng.integers(-2, 4, size) * (rng.random(size) < 0.4),
        "zero": np.zeros(size),
        "dirty": rng.integers(1, 1 << 30, size),  # sums wrap like int32
    }[kind].astype(np.int32)
    summed = counts.sum(0, dtype=np.int64).astype(np.int32)
    if m == 1:
        want = ref_pk.compact_counts_packed(jnp.asarray(summed[0]), interpret=True)
    else:
        want = ref_pk.compact_counts_multiround_packed(jnp.asarray(summed), interpret=True)
    want = np.asarray(want)
    for fn in (compact_counts, compact_counts_torch):
        rows = torch.tensor(counts)
        got = fn(rows).numpy()
        k = int(want[t_total])
        np.testing.assert_array_equal(got[:k], want[:k])  # past the count: unspecified
        np.testing.assert_array_equal(got[t_total:], want[t_total:])
        assert not rows.any()


def test_compact_counts_writes_its_out_buffer():
    """With ``out``, the fold writes the ids into the front of the caller's
    buffer (t_total + 2 cells at m = 1, + 3 at m > 1) and returns that view;
    it refuses a buffer too short or of another type."""
    t_total = 5
    counts = torch.tensor([[[0, 1, 0, 2, 0]], [[0, 0, 0, -2, 3]]], dtype=torch.int32)
    out = torch.full((t_total + 3,), -7, dtype=torch.int32)
    got = compact_counts(counts.clone(), out)
    assert got.data_ptr() == out.data_ptr() and got.numel() == t_total + 2
    assert got.tolist() == [1, 4, 0, 0, 0, 2, 4] and int(out[-1]) == -7
    for bad in (torch.zeros(t_total + 1, dtype=torch.int32), torch.zeros(t_total + 3)):
        with pytest.raises(ValueError, match="out"):
            compact_counts(counts.clone(), bad)
    with pytest.raises(ValueError, match="S >= 1"):
        compact_counts(counts[0])


# ------------------------------------------------- the sharded frontier


@pytest.fixture(scope="module")
def spmd_reference():
    """The reference's gossip_frontier_shardmap_dense (interpret, fuse 1)
    on its 8-device mesh, once per case: {(mode, lean, wrap, max_rounds):
    (table, fields, rounds, last_changed)}."""
    p, n = 64, 512
    out = {}
    for mode, lean in (("reference", False), ("lww", False), ("reference", True)):
        for wrap, max_rounds in ((True, 66), (False, 66), (True, 7), (False, 12)):
            t = sparse_fields(p, n, seed=55)
            tbl, mesh = jax_sharded(t)
            got, r, c = ref_sg.gossip_frontier_shardmap_dense(
                tbl, jnp.ones(1, bool), mesh, wrap, mode, lean, max_rounds, interpret=True)
            out[mode, lean, wrap, max_rounds] = (t, [np.asarray(f) for f in got], int(r), int(c))
    return out


@needs_devices
@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("wrap,max_rounds", [(True, 66), (False, 66), (True, 7), (False, 12)])
@pytest.mark.parametrize("mode,lean", [("reference", False), ("lww", False), ("reference", True)])
def test_frontier_shardmap_dense_matches_reference(spmd_reference, mode, lean, wrap, max_rounds,
                                                   fuse):
    """8 shards of 8 rows: converging (66 > P + 1), cut off inside the
    first fused step (7) or in the tail (12); fused and single-round
    loops land on the reference's state, rounds and residual."""
    t, want, r_want, c_want = spmd_reference[mode, lean, wrap, max_rounds]
    table = sharded(t)
    tile = frontier_tile_n(512)
    got, r_got, c_got = sg.gossip_frontier_shardmap_dense(
        table, torch.ones(512 // tile, dtype=torch.bool), wrap, mode, lean, max_rounds,
        fuse=fuse)
    assert_fields_equal(got, want)
    assert (r_got, c_got) == (r_want, c_want)
    if lean:  # writer, ctr and tick untouched
        assert_fields_equal(got, [*want[:4], *t[4:]])


@needs_devices
@pytest.mark.parametrize("fuse", [1, 8])
def test_frontier_shardmap_dense_sparse_seed_and_empty(fuse):
    """From a converged table, one changed entry and its one seeded stripe
    land on the reference's classic loop from the whole table; an empty
    seed runs nothing."""
    p, n = 64, 512
    tile = frontier_tile_n(n)
    nb = jnp.asarray(jax_topo.ring(p).neighbors)
    base, _, _ = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in sparse_fields(p, n, seed=83))), nb, "ring",
        "reference", p + 2)
    upd = [np.array(f) for f in base]
    upd[0][3, tile + 9] = 3
    upd[1][3, tile + 9] = 10**9
    want, r_want, _ = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in upd)), nb, "ring", "reference", p + 2)
    dirty = torch.zeros(n // tile, dtype=torch.bool)
    dirty[1] = True
    got, rounds, changed = sg.gossip_frontier_shardmap_dense(
        sharded(upd), dirty, True, "reference", False, p + 2, fuse=fuse)
    assert_fields_equal(got, want)
    assert (rounds, changed) == (int(r_want), 0)
    got, rounds, changed = sg.gossip_frontier_shardmap_dense(
        sharded(upd), torch.zeros(n // tile, dtype=torch.bool), True, "reference", False,
        p + 2, fuse=fuse)
    assert (rounds, changed) == (0, 0)
    assert_fields_equal(got, upd)
