"""The port's packed layout (bullet_tpu_torch/ops/packed.py) against the
reference's (bullet_tpu/ops/packed.py): the merge, the whole-table rounds,
the flat apply (against the scan apply, the winners+scatter path, the
chunk-grid and the windowed Pallas applies), the in-place round, fused
rounds and the count-only probe (against the full-P stripe and halo
Pallas kernels), the direct reconcile, and the compacting frontier step
and loop. Pallas runs in interpret mode, as tests/test_packed.py runs it;
the port runs its plain versions (the CPU route of every wrapper).
Tolerance: exact (int32 fields, counts, ids, rounds and residuals)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.ops import packed as jpk
from bullet_tpu.ops.apply import OpBatch
from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.ops.merge import merge_tables_xla
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu.ops import rank as jrk
from bullet_tpu.ops.rank import Rank1Table as JaxRank1, RankTable as JaxRank
from bullet_tpu.parallel.gossip import gossip_round_chain, gossip_round_mesh, gossip_round_ring
from bullet_tpu_torch.convert import (
    FROM_NUMPY,
    packed_from_numpy,
    packed_to_numpy,
    table_from_numpy,
    table_to_numpy,
)
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.parallel import topology as topo

from _kernel_models import (
    APPLY_BLOCKS_PER_SM,
    APPLY_THREADS,
    PipeKey,
    apply_model,
    frontier_pipe_model,
    multiround_model,
)

torch.set_num_threads(2)


def dense_np(p, n, seed):
    """The reference tests' sim-realistic dense table (random_dense in
    tests/test_packed.py): absent entries all-zero, metadata zero."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, (p, n), dtype=np.int32)
    present = cls > 0
    z = np.zeros((p, n), np.int32)

    def m(lo, hi):
        return np.where(present, rng.integers(lo, hi, (p, n), dtype=np.int32), z)

    return [cls, m(-50, 50), m(-50, 50), m(0, 30), z, z.copy(), z.copy()]


def packed_np(p, n, seed):
    cls, khi, klo, vid = dense_np(p, n, seed)[:4]
    return [khi, klo, ((cls << 28) | vid).astype(np.int32)]


def tie_np(p, n, seed):
    """Packed fields with many ties and absent (cls 0) entries whose khi/klo
    are nonzero, some negative: these lose to a chain end's all-zero row."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, (p, n))
    vid = rng.integers(0, 4, (p, n))
    return [rng.integers(-3, 3, (p, n), dtype=np.int32),
            rng.integers(-3, 3, (p, n), dtype=np.int32),
            ((cls << 28) | vid).astype(np.int32)]


def jt(fields):
    return jpk.PackedTable(*(jnp.asarray(f) for f in fields))


def jfam(fields):
    """A reference table of the packed family, by field count."""
    return {3: jpk.PackedTable, 2: JaxRank, 1: JaxRank1}[len(fields)](
        *(jnp.asarray(f) for f in fields))


def family_np(nf, p, n, seed):
    """Packed-family fields with many ties: packed as ``tie_np``; rank and
    rank1 ranks in [0, 6), 0 absent, cv a function of the rank."""
    if nf == 3:
        return tie_np(p, n, seed)
    rank = np.random.default_rng(seed).integers(0, 6, (p, n)).astype(np.int32)
    return [rank, np.where(rank > 0, (1 << 28) | rank, 0).astype(np.int32)][:nf]


def pt(fields):
    return packed_from_numpy(fields, "cpu")


def assert_same(port, ref, msg=""):
    for a, b in zip(packed_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b), msg)


# ------------------------------------------------------------ data, merge


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_packed_matches_dense(seed):
    a, b = dense_np(16, 256, seed), dense_np(16, 256, seed + 100)
    want, c_want = jpk.merge_packed_xla(jpk.pack_table(JaxTable(*a)), jpk.pack_table(JaxTable(*b)))
    got, c_got = pk.merge_packed_torch(
        pk.pack_table(table_from_numpy(a, "cpu")), pk.pack_table(table_from_numpy(b, "cpu"))
    )
    assert_same(got, want)
    assert int(c_got) == int(c_want)
    dense, c_dense = merge_tables_xla(JaxTable(*a), JaxTable(*b), "reference")
    for x, y in zip(pk.unpack_table(got)[:4], dense[:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(c_got) == int(c_dense)


def test_pack_unpack_and_keys_match_reference():
    d = dense_np(8, 64, 3)
    got = pk.pack_table(table_from_numpy(d, "cpu"))
    want = jpk.pack_table(JaxTable(*d))
    assert_same(got, want)
    for x, y in zip(pk.unpack_table(got), jpk.unpack_table(want)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert (pk.CV_SHIFT, pk.VID_MASK, pk.MAX_VID) == (jpk.CV_SHIFT, jpk.VID_MASK, jpk.MAX_VID)
    vals = [torch.from_numpy(f) for f in packed_np(8, 64, 4)]
    jvals = [jnp.asarray(f.numpy()) for f in vals]
    for nf in (1, 2, 3):  # packed, rank and rank1 arities
        for x, y in zip(pk.table_keys(vals[-nf:]), jpk.table_keys(tuple(jvals[-nf:]))):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(
            pk.op_present(vals[-nf:]).numpy(), np.asarray(jpk.op_present(tuple(jvals[-nf:])))
        )


# ------------------------------------------------------------------ rounds


@pytest.mark.parametrize("kind", ["ring", "chain", "mesh"])
def test_rounds_match_dense(kind):
    d = dense_np(16, 256, 3)
    t = jpk.pack_table(JaxTable(*d))
    jax_fn = {"ring": jpk.gossip_round_ring_packed, "chain": jpk.gossip_round_chain_packed,
              "mesh": jpk.gossip_round_mesh_packed}[kind]
    port_fn = {"ring": pk.gossip_round_ring_packed, "chain": pk.gossip_round_chain_packed,
               "mesh": pk.gossip_round_mesh_packed}[kind]
    dense_fn = {"ring": gossip_round_ring, "chain": gossip_round_chain,
                "mesh": gossip_round_mesh}[kind]
    want, c_want = jax_fn(t)
    got, c_got = port_fn(pt([np.asarray(f) for f in t]))
    assert_same(got, want)
    assert int(c_got) == int(c_want)
    dense, c_dense = dense_fn(JaxTable(*d), "reference")
    assert int(c_got) == int(c_dense)
    for x, y in zip(pk.unpack_table(got)[:4], dense[:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_generic_round_matches_reference():
    f = packed_np(11, 256, 4)
    jnb = jnp.asarray(jax_topo.bridge((5, 5), 1).neighbors)
    want, c_want = jpk.gossip_round_generic_packed(jt(f), jnb)
    got, c_got = pk.gossip_round_generic_packed(pt(f), topo.bridge((5, 5), 1).neighbors)
    assert_same(got, want)
    assert int(c_got) == int(c_want)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("p,n,data", [(16, 256, "dense"), (8, 128, "ties"), (1, 128, "ties"),
                                      (3, 130, "ties")])
def test_pallas_round_matches_xla(p, n, data, wrap):
    """ring_round_packed (the plain version on the CPU) against the XLA
    round and, where the reference tiles the shape, its in-place full-P
    stripe kernel in interpret mode."""
    f = packed_np(p, n, 5) if data == "dense" else tie_np(p, n, 5)
    xla = jpk.gossip_round_ring_packed if wrap else jpk.gossip_round_chain_packed
    refs = [xla(jt(f))]
    if jpk.packed_ring_supported(p, n):
        refs.append(jpk.ring_round_packed_pallas(jt(f), wrap=wrap, interpret=True))
    got, c_got = pk.ring_round_packed(pt(f), wrap)
    for want, c_want in refs:
        assert_same(got, want)
        assert int(c_got) == int(c_want)


def test_chain_end_zero_row_is_compared():
    """An absent entry with khi < 0 at a chain end loses to the missing
    (all-zero) neighbour, and the count records it."""
    f = [np.zeros((2, 1), np.int32) for _ in range(3)]
    f[0][0, 0] = -5
    want, c_want = jpk.gossip_round_chain_packed(jt(f))
    got, c_got = pk.ring_round_packed(pt(f), wrap=False)
    assert_same(got, want)
    assert int(c_got) == int(c_want) == 1


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_multiround_matches_reference(m, wrap):
    """m rounds in one call: the summed count and the table of m classic
    rounds; against the reference's fused stripe kernel in interpret mode
    for m <= 3 (its compile grows with m)."""
    f = packed_np(64, 1024, 5)
    xla = jpk.gossip_round_ring_packed if wrap else jpk.gossip_round_chain_packed
    want, total = jt(f), 0
    for _ in range(m):
        want, c = xla(want)
        total += int(c)
    got, c_got = pk.ring_multiround_packed(pt(f), wrap, m)
    assert_same(got, want)
    assert int(c_got) == total
    if m <= 3:
        fused, c_fused = jax.jit(jpk.ring_multiround_packed_traced, static_argnums=(1, 2, 3))(
            jt(f), wrap, m, True)
        assert_same(got, fused)
        assert int(c_fused) == total


# the shapes #11's schedule is held at: one peer, a ragged stripe (130 and
# 1000 columns leave the last 256-column block part empty), a ring shorter
# than the pass's 16 extension rows, more rows than stages
MULTIROUND_SHAPES = [(1, 64), (3, 130), (17, 300), (64, 1000)]
XLA_ROUND = {True: jax.jit(jpk.gossip_round_ring_packed),
             False: jax.jit(jpk.gossip_round_chain_packed)}


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 40])
@pytest.mark.parametrize("shape", MULTIROUND_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_multiround_schedule_matches_reference(nf, wrap, m, shape):
    """#11 as the card schedules m rounds (packed_round.cu: m // 8
    pipelined passes of frontier.cuh's stages over every stripe with a
    total count, then m % 8 sweeps; ``multiround_model``) and the port's
    ``ring_multiround_packed`` (the plain version on the CPU), table and
    summed count, against m of the reference's XLA rounds. None of these
    shapes is one the reference's fused stripe kernel tiles: the next test
    holds the schedule against that kernel."""
    p, n = shape
    f = family_np(nf, p, n, 90 + 7 * p + m + nf)
    xla = XLA_ROUND[wrap]
    want, total = jfam(f), 0
    for _ in range(m):
        want, c = xla(want)
        total += int(c)
    model = [torch.from_numpy(x.copy()) for x in f]
    c_model = multiround_model(model, wrap, m, PipeKey(FAMILY[nf]))
    got, c_got = pk.ring_multiround_packed(FROM_NUMPY[FAMILY[nf]](f, "cpu"), wrap, m)
    for table, count in ((model, c_model), (got, int(c_got))):
        for a, b in zip(table, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert count == pk._wrap_int32(total)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_multiround_schedule_interpret_kernel(wrap, m):
    """Where the reference's fused stripe kernel tiles the shape (p % 8 == 0,
    n % 128 == 0), the schedule's model against it in interpret mode at
    m <= 3 (sweeps only: its compile grows with m) on every layout."""
    p, n = 16, 256
    for nf in (3, 2, 1):
        f = family_np(nf, p, n, 60 + nf)
        assert jpk.packed_ring_supported(p, n)
        fused, c_fused = jpk.ring_multiround_packed_traced(jfam(f), wrap, m, True)
        model = [torch.from_numpy(x.copy()) for x in f]
        assert multiround_model(model, wrap, m, PipeKey(FAMILY[nf])) == int(c_fused)
        for a, b in zip(model, fused):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_multiround_count_wraps_like_int32():
    """The schedule's count is unsigned atomicAdds into one int32, so a sum
    past 2^31 wraps as the reference's int32 sum does: started 5 below
    2^31, the 16 rounds' count lands negative, and equals the wrapped sum
    of the start and the plain version's count."""
    f = family_np(3, 64, 1000, 5)
    _, c_plain = pk.ring_multiround_packed(pt(f), True, 16)
    start = (1 << 31) - 5
    model = [torch.from_numpy(x.copy()) for x in f]
    c_model = multiround_model(model, True, 16, PipeKey("packed"), count=start)
    assert int(c_plain) > 5
    assert c_model == pk._wrap_int32(start + int(c_plain)) < 0


@pytest.mark.parametrize("wrap", [True, False])
def test_packed_halo_round_matches_xla(wrap):
    """P = 4096 is past the reference's full-P stripe budget: it takes the
    halo kernel (#27), which the port's column-owning round also covers."""
    p, n = 4096, 128
    assert not jpk.packed_ring_supported(p, n) and jpk.packed_halo_supported(p, n)
    tile_p, _ = jpk._halo_tiles_packed(p, n)
    assert p // tile_p >= 2
    f = packed_np(p, n, 11)
    want, c_want = jax.jit(jpk.halo_round_packed_traced, static_argnums=(1, 2))(jt(f), wrap, True)
    got, c_got = pk.ring_round_packed(pt(f), wrap)
    assert_same(got, want)
    assert int(c_got) == int(c_want)
    probe = pk.count_changes_round_packed(pt(f), wrap)
    assert int(probe) == int(c_want)


@pytest.mark.parametrize("wrap", [True, False])
def test_count_changes_probe_matches_round(wrap):
    f = packed_np(16, 512, 44)
    before = pt(f)
    _, c_real = jpk.ring_round_packed_pallas(jt(f), wrap=wrap, interpret=True)
    c_ref = jpk.count_changes_round_packed(jt(f), wrap, True)
    c_probe = pk.count_changes_round_packed(before, wrap)
    assert int(c_probe) == int(c_real) == int(c_ref)
    assert_same(before, f)  # the probe wrote nothing
    done, rounds, last = pk.gossip_until_converged_packed(
        pt(f), topo.ring(16) if wrap else topo.chain(16), 20)
    assert last == 0 and 0 < rounds < 20
    assert int(pk.count_changes_round_packed(done, wrap)) == 0


@pytest.mark.parametrize("kind,max_rounds", [("ring", 20), ("chain", 20), ("mesh", 4),
                                             ("star", 6), ("ring", 3)])
def test_until_converged_matches_reference(kind, max_rounds):
    p = 12
    f = packed_np(p, 256, 8)
    jtopo = getattr(jax_topo, "full_mesh" if kind == "mesh" else kind)(p)
    want, r_want, c_want = jpk.gossip_until_converged_packed(
        jt(f), jnp.asarray(jtopo.neighbors), jtopo.kind, max_rounds)
    port_topo = getattr(topo, "full_mesh" if kind == "mesh" else kind)(p)
    got, r_got, c_got = pk.gossip_until_converged_packed(pt(f), port_topo, max_rounds)
    assert_same(got, want)
    assert (r_got, c_got) == (int(r_want), int(c_want))


# ------------------------------------------------------------------- apply


def random_ops(rng, p, n, k, slots_hi=None, full_range=False):
    slots_hi = slots_hi or n
    if full_range:
        khi = rng.integers(-(2**31), 2**31, k, dtype=np.int64).astype(np.int32)
        klo = rng.integers(-(2**31), 2**31, k, dtype=np.int64).astype(np.int32)
        vid = rng.integers(0, 1 << 28, k).astype(np.int32)
    else:
        khi = rng.integers(-10**6, 10**6, k).astype(np.int32)
        klo = rng.integers(-10**6, 10**6, k).astype(np.int32)
        vid = rng.integers(0, 1 << 20, k).astype(np.int32)
    return (rng.integers(0, p, k).astype(np.int32),
            rng.integers(0, min(n, slots_hi), k).astype(np.int32),
            rng.integers(0, 5, k).astype(np.int32), khi, klo, vid)


def port_apply(base, raw):
    reduced = pk.reduce_flat_ops(*raw)
    return pk.apply_flat_packed(pt(base), torch.from_numpy(np.stack(reduced)))


def test_apply_matches_dense_values():
    """The port's flat apply from an empty table == the reference's scan
    apply (apply_ops_packed) on the same ops, values and wins."""
    rng = np.random.default_rng(6)
    p, n, b = 8, 64, 5
    ops = [rng.integers(0, n, (p, b)), rng.integers(0, 4, (p, b)),
           rng.integers(-50, 50, (p, b)), rng.integers(-50, 50, (p, b)),
           rng.integers(0, 30, (p, b)), rng.integers(1, 9, (p, b))]
    ops = [o.astype(np.int32) for o in ops]
    want, _ = jpk.apply_ops_packed(
        jpk.init_packed(p, n), OpBatch(*(jnp.asarray(o) for o in ops)), jnp.int32(1))
    peer = np.repeat(np.arange(p, dtype=np.int32), b)
    got, _ = port_apply([np.zeros((p, n), np.int32)] * 3,
                        (peer, *(o.reshape(-1) for o in ops[:5])))
    assert_same(got, want)


@pytest.mark.parametrize("native", [True, False])
def test_reduce_flat_ops_matches_reference(native, monkeypatch):
    """The port's reduction (native pass, and the numpy fallback) gives
    the reference's winners in (peer, slot) order."""
    from bullet_tpu_torch import native as port_native

    if not native:
        monkeypatch.setattr(port_native, "reduce_flat_ops", lambda *a: NotImplemented)
    rng = np.random.default_rng(9)
    for full in (False, True):
        raw = random_ops(rng, 16, 512, 3000, slots_hi=64, full_range=full)
        want = jpk.reduce_flat_ops(*raw)
        got = pk.reduce_flat_ops(*raw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    z = np.zeros(4, np.int32)
    assert pk.reduce_flat_ops(z, z, z, z, z, z) is None  # no live op


def _ref_scatter(base, raw):
    reduced = jpk.reduce_flat_ops(*raw)
    return jpk.apply_flat_packed(jt(base), *(jnp.asarray(a) for a in reduced))


@pytest.mark.parametrize("p,n,k,slots_hi", [(16, 512, 60, 512), (64, 2048, 200, 2048),
                                            (8, 256, 30, 256), (16, 4096, 6000, 256)])
def test_blocked_apply_bitidentical_to_scatter(p, n, k, slots_hi):
    """TPU kernel #9 (the chunk-grid apply, interpret mode) and the
    winners+scatter path against the port's flat apply: same table, same
    applied count. The last case packs hundreds of ops per block."""
    rng = np.random.default_rng(17 + p + k)
    raw = random_ops(rng, p, n, k, slots_hi)
    base = packed_np(p, n, p)
    want, a_want = _ref_scatter(base, raw)
    blocked = jpk.reduce_flat_ops(*raw, block_shape=(p, n))
    chunked, a_chunked = jpk.apply_flat_blocked(jt(base), *jpk.chunk_block_ops(*blocked, p, n))
    got, a_got = port_apply(base, raw)
    for ref, a_ref in ((want, a_want), (chunked, a_chunked)):
        assert_same(got, ref)
        assert int(a_got) == int(a_ref)


@pytest.mark.parametrize("p,n,k,slots_hi", [(16, 2048, 500, 2048), (64, 4096, 2000, 512),
                                            (8, 1024, 320, 40)])
def test_windowed_apply_bitidentical_to_scatter(p, n, k, slots_hi):
    """TPU kernel #10 (the windowed one-hot apply, interpret mode) on dense
    batches with full-range keys against the port's flat apply."""
    rng = np.random.default_rng(41 + k)
    raw = random_ops(rng, p, n, k, slots_hi, full_range=True)
    assert jpk.window_apply_supported(p, n)
    base = packed_np(p, n, p + 1)
    blocked = jpk.reduce_flat_ops(*raw, block_shape=(p, n))
    want, a_want = jpk.apply_flat_windowed(jt(base), *jpk.window_block_ops(*blocked, p, n))
    got, a_got = port_apply(base, raw)
    assert_same(got, want)
    assert int(a_got) == int(a_want)


def test_apply_drops_out_of_range_and_dead_ops():
    """Ops outside the table (the reference's padding rows) and cls-0 ops
    never land; a full-width batch beating everything lands everywhere."""
    p, n = 4, 8
    base = packed_np(p, n, 2)
    ops = torch.tensor([[0, 3, 1, 2], [1, n, 5, 7], [9, 9, 9, 9], [0, 0, 0, 0],
                        [(5 << 28) | 1, (5 << 28) | 1, 0, (6 << 28) | 2]], dtype=torch.int32)
    got, applied = pk.apply_flat_packed(pt(base), ops)
    assert int(applied) == 2
    want = [f.copy() for f in base]
    for peer, slot, cv in ((0, 1, (5 << 28) | 1), (2, 7, (6 << 28) | 2)):
        want[0][peer, slot], want[1][peer, slot], want[2][peer, slot] = 9, 0, cv
    assert_same(got, want)


FAMILY = {3: "packed", 2: "rank", 1: "rank1"}


def model_apply_case(nf, seed, p=16, n=1024, k=9000):
    """A table of nf fields with many ties and K unique (peer, slot) ops
    for it, sorted by (peer, slot): live and dead (cls 0, rank 0) values,
    ties (a tenth copy the entry they target), then out-of-range rows
    (peer or slot outside the table) appended. The ops span several of
    the apply kernel's blocks. Returns (table fields, ops [2 + nf, K],
    the in-range count)."""
    rng = np.random.default_rng(seed)
    base = family_np(nf, p, n, seed)
    flat = np.sort(rng.choice(p * n, k, replace=False))
    peer, slot = (flat // n).astype(np.int32), (flat % n).astype(np.int32)
    if nf == 3:
        cls, vid = rng.integers(0, 4, k), rng.integers(0, 5, k)
        vals = [rng.integers(-3, 3, k), rng.integers(-3, 3, k), (cls << 28) | vid]
    else:
        rank = rng.integers(0, 8, k)
        vals = [rank, np.where(rank > 0, (1 << 28) | rank, 0)][:nf]
    tie = rng.random(k) < 0.1
    vals = [np.where(tie, b.reshape(-1)[flat], v).astype(np.int32) for b, v in zip(base, vals)]
    stray = np.array([[-1, 0], [p, 3], [p + 3, n - 1], [0, -1], [p - 1, n], [2, n + 7]],
                     np.int32).T
    stray_vals = [np.full(stray.shape[1], v, np.int32)
                  for v in ((5, 0, (5 << 28) | 1) if nf == 3 else (7, (1 << 28) | 7))[:nf]]
    ops = np.concatenate([np.stack([peer, slot, *vals]), np.vstack([stray, *stray_vals])], 1)
    return base, ops.astype(np.int32), k


def reference_apply(base, ops, k):
    """The reference's flat apply of the first k (in-range, sorted) ops."""
    nf = len(base)
    arrays = [jnp.asarray(a) for a in ops[:, :k]]
    if nf == 3:
        return jpk.apply_flat_packed(jt(base), *arrays)
    if nf == 2:
        return jrk.apply_flat_rank(jfam(base), *arrays)
    return jrk.apply_flat_rank1(jfam(base), *arrays)


def check_apply_model(nf, order, seed):
    """apply_model (the kernel's schedule) and the plain version on sorted
    or shuffled ops against the reference on the sorted in-range ops:
    tables and applied counts equal, on the H100's grid and on one small
    enough that every thread takes several ops in turn. The model reads no
    entry for a dead or out-of-range op, the rank layouts' cv never, and
    the packed keys khi and klo only on ties."""
    base, ops, k = model_apply_case(nf, seed)
    want, a_want = reference_apply(base, ops, k)
    if order == "shuffled":
        ops = ops[:, np.random.default_rng(seed).permutation(ops.shape[1])]
    port_ops = torch.from_numpy(np.ascontiguousarray(ops))
    layout = FAMILY[nf]
    plain, a_plain = pk.apply_flat_packed_torch(FROM_NUMPY[layout](base, "cpu"), port_ops)
    results = [(plain, a_plain)]
    live = (ops[-1] >> 28 > 0) if nf > 1 else ops[2] > 0
    live &= (ops[0] >= 0) & (ops[0] < base[0].shape[0]) & (ops[1] >= 0)
    live &= ops[1] < base[0].shape[1]
    for sms in (132, 1):
        modelled = FROM_NUMPY[layout](base, "cpu")
        a_model, reads = apply_model(modelled, port_ops, layout, sms)
        results.append((modelled, a_model))
        key = 2 if nf == 3 else 0
        assert reads[key] == int(live.sum())
        if nf == 3:
            assert reads[key] > reads[0] >= reads[1] > 0
        else:
            assert reads[1:] == [0] * (nf - 1)
    assert port_ops.shape[1] > 2 * APPLY_THREADS * APPLY_BLOCKS_PER_SM
    for got, applied in results:
        for a, b in zip(table_to_numpy(got), want):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert int(applied) == int(a_want) > 0
    assert int(a_want) < k  # ties and dead values did not land


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_model_matches_reference(order, seed):
    """#9/#10 at nf = 3: the CUDA kernel's schedule (apply_model: one op a
    thread in turn over a capped grid, the entry's planes read only as far
    as the compare needs) on sorted and shuffled ops with dead values, ties
    and out-of-range rows."""
    check_apply_model(3, order, seed)


# --------------------------------------------------------------- reconcile


@pytest.mark.parametrize("p,n", [(64, 1024), (8, 256), (48, 2048), (1, 128), (2, 64),
                                 (3, 96), (1000, 64)])
def test_reconcile_kernel_bitidentical_to_xla(p, n):
    """The port's reconcile (the doubling plain version on the CPU) against
    the reference's XLA doubling join and its stripe kernel (#15, interpret
    mode, where it tiles); and the column lexmax that the CUDA kernel
    computes directly, held against the same doubling result."""
    f = tie_np(p, n, 90 + p) if p < 8 else packed_np(p, n, 90 + p)
    want = jpk.reconcile_packed_xla(jt(f))
    refs = [want]
    if jpk.packed_ring_supported(p, n):
        refs.append(jax.jit(jpk.reconcile_packed_traced, static_argnums=(1,))(jt(f), True))
    got = pk.reconcile_packed(pt(f))
    for ref in refs:
        assert_same(got, ref)
    khi, klo, cv = f
    # the row holding each column's max of (cls, khi, klo, cv); equal keys
    # mean an equal entry, so ties may pick any of them
    best = np.lexsort((cv, klo, khi, cv >> 28), axis=0)[-1]
    for field, g in zip(f, packed_to_numpy(got)):
        np.testing.assert_array_equal(g, np.broadcast_to(field[best, np.arange(n)], (p, n)))


# ---------------------------------------------------------------- frontier


def test_frontier_tile_n():
    assert pk.frontier_tile_n(1 << 20) == 256
    assert pk.frontier_tile_n(128) == 128
    assert pk.frontier_tile_n(1000) == 0
    assert pk.frontier_tile_n(4160) == 160


def _ids(flags, m):
    ids = pk.frontier_ids_compact(torch.from_numpy(np.asarray(flags)), len(flags))
    return torch.cat([ids, torch.zeros(1, dtype=torch.int32)]) if m > 1 else ids


def _check_step(got, ids_got, want, ids_want, t_total):
    assert_same(got, want)
    ids_got, ids_want = ids_got.numpy(), np.asarray(ids_want)
    count = int(ids_want[t_total])
    np.testing.assert_array_equal(ids_got[:count], ids_want[:count])
    np.testing.assert_array_equal(ids_got[t_total:], ids_want[t_total:])


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("wrap,dirty", [(True, "all"), (False, "sparse")])
def test_frontier_round_matches_pallas_interpret(m, wrap, dirty):
    """One compacting step at a shape where both packages use one stripe
    width (256): #20 (m = 1) and #19 (m = 4) in interpret mode."""
    p, n = 512, 1024
    tile = pk.frontier_tile_n(n)
    assert tile == jpk.frontier_tile_n(p, n) == 256
    t_total = n // tile
    flags = np.ones(t_total, bool) if dirty == "all" else np.arange(t_total) % 2 == 1
    f = packed_np(p, n, 5)
    ids = _ids(flags, m)
    if m == 1:
        want, ids_want = jpk.frontier_round_packed_traced(
            jt(f), jnp.asarray(ids.numpy()), wrap, True)
    else:
        want, ids_want = jpk.frontier_multiround_packed_traced(
            jt(f), jnp.asarray(ids.numpy()), wrap, m, True)
    got, ids_got = pk.frontier_round_packed(pt(f), ids, tile, wrap, m)
    _check_step(got, ids_got, want, ids_want, t_total)
    if m > 1:
        # the pipelined pass's schedule at depth m
        model = pt(f)
        ids_model = frontier_pipe_model(model, ids, tile, wrap, PipeKey("packed"), m)
        _check_step(model, ids_model, want, ids_want, t_total)


def _frontier_xla_twin(f, ids, tile, wrap, m):
    """m classic XLA rounds on each active stripe's columns; the next ids
    array from the per-stripe round counts."""
    t_total = f[0].shape[1] // tile
    count = int(ids[t_total])
    out = [a.copy() for a in f]
    xla = jpk.gossip_round_ring_packed if wrap else jpk.gossip_round_chain_packed
    keep, changed, max_last = [], 0, 0
    for s in ids[:count].tolist():
        cols = slice(s * tile, (s + 1) * tile)
        sub, last = jfam([a[:, cols] for a in out]), 0
        for k in range(1, m + 1):
            sub, c = xla(sub)
            changed += int(c)
            last = k if int(c) else last
        for a, g in zip(out, sub):
            a[:, cols] = np.asarray(g)
        max_last = max(max_last, last)
        if last == m:
            keep.append(s)
    ids_out = np.zeros(len(ids), np.int32)
    ids_out[: len(keep)] = keep
    ids_out[t_total], ids_out[t_total + 1] = len(keep), changed
    if m > 1:
        ids_out[t_total + 2] = max_last
    return out, ids_out


@pytest.mark.parametrize("wrap,dirty,seed", [(True, "all", 5), (False, "sparse", 6)])
def test_frontier_halo_round_matches_pallas_interpret(wrap, dirty, seed):
    """P = 4096: the reference's frontier step takes its halo kernel (#18),
    on 128-wide stripes, which the port is given too. The fused m = 8 step
    (#16's work) is held against eight XLA rounds per stripe."""
    p, n = 4096, 128 * 3
    tile = jpk.frontier_tile_n(p, n)  # the port takes the reference's width here
    assert tile == 128 and pk.frontier_tile_n(n) == 192
    assert not jpk.packed_ring_supported(p, n) and jpk.packed_halo_supported(p, n)
    t_total = n // tile
    flags = np.ones(t_total, bool) if dirty == "all" else np.arange(t_total) != 1
    f = packed_np(p, n, seed)
    ids = _ids(flags, 1)
    want, ids_want = jpk.frontier_round_packed_traced(jt(f), jnp.asarray(ids.numpy()), wrap, True)
    got, ids_got = pk.frontier_round_packed(pt(f), ids, tile, wrap, 1)
    _check_step(got, ids_got, want, ids_want, t_total)
    ids8 = _ids(flags, 8)
    want8, ids_want8 = _frontier_xla_twin(f, ids8.numpy(), tile, wrap, 8)
    got8, ids_got8 = pk.frontier_round_packed(pt(f), ids8, tile, wrap, 8)
    _check_step(got8, ids_got8, want8, ids_want8, t_total)


@pytest.mark.parametrize("wrap,dirty,seed", [(True, "all", 5), (False, "sparse", 6),
                                             (True, "sparse", 7)])
def test_frontier_round_fused_matches_xla_twin(wrap, dirty, seed):
    p, n, m = 24, 1024, 8
    tile = pk.frontier_tile_n(n)
    t_total = n // tile
    flags = np.ones(t_total, bool) if dirty == "all" else np.arange(t_total) % 2 == 0
    f = packed_np(p, n, seed)
    ids = _ids(flags, m)
    want, ids_want = _frontier_xla_twin(f, ids.numpy(), tile, wrap, m)
    got, ids_got = pk.frontier_round_packed(pt(f), ids, tile, wrap, m)
    _check_step(got, ids_got, want, ids_want, t_total)


@pytest.mark.parametrize("kind", ["ring", "chain"])
def test_frontier_loop_bitidentical_to_classic(kind):
    """The frontier loop (settled stripes skipped) reaches the classic
    loop's fixed point in the same round count, residual 0."""
    p, n = 64, 8192
    f = packed_np(p, n, 31)
    nb = jnp.asarray(getattr(jax_topo, kind)(p).neighbors)
    want, r_want, _ = jpk.gossip_until_converged_packed(jt(f), nb, kind, p + 2)
    t_total = n // pk.frontier_tile_n(n)
    got, r_got, c_got = pk.gossip_frontier_packed(
        pt(f), torch.ones(t_total, dtype=torch.bool), kind == "ring", p + 2)
    assert_same(got, want, kind)
    assert r_got == int(r_want)
    assert c_got == 0


def test_frontier_sparse_start():
    """From a converged table, dirtying one stripe converges with only that
    stripe seeded — the classic loop's state."""
    p, n = 64, 8192
    tile = pk.frontier_tile_n(n)
    nb = jnp.asarray(jax_topo.ring(p).neighbors)
    base, _, _ = jpk.gossip_until_converged_packed(jt(packed_np(p, n, 32)), nb, "ring", p + 2)
    upd = [np.array(f) for f in base]
    upd[2][3, 2 * tile + 7] = (2 << 28) | 12345
    upd[0][3, 2 * tile + 7] = 99999
    dirty = torch.zeros(n // tile, dtype=torch.bool)
    dirty[2] = True
    got, rounds, last = pk.gossip_frontier_packed(pt(upd), dirty, True, p + 2)
    want, r_want, _ = jpk.gossip_until_converged_packed(jt(upd), nb, "ring", p + 2)
    assert_same(got, want)
    assert (rounds, last) == (int(r_want), 0)


def test_frontier_fused_round_parity():
    """fuse > 1: the exact classic round count and residual, across
    convergence lengths at every offset in a fuse block, max_rounds
    cutoffs, and an empty frontier."""
    p, n = 16, 2048
    t_total = n // pk.frontier_tile_n(n)
    nb = jnp.asarray(jax_topo.ring(p).neighbors)
    for seed in range(2):
        f = packed_np(p, n, 60 + seed)
        for max_rounds in (p + 2, 7, 3, 0):
            want, r_want, c_want = jpk.gossip_until_converged_packed(jt(f), nb, "ring", max_rounds)
            for fuse in (1, 2, 5, 8):
                got, r_got, c_got = pk.gossip_frontier_packed(
                    pt(f), torch.ones(t_total, dtype=torch.bool), True, max_rounds, fuse=fuse)
                assert_same(got, want, (seed, max_rounds, fuse))
                assert (r_got, c_got) == (int(r_want), int(c_want)), (seed, max_rounds, fuse)
    f = packed_np(p, n, 70)
    got, r, c = pk.gossip_frontier_packed(
        pt(f), torch.zeros(t_total, dtype=torch.bool), True, p + 2, fuse=5)
    assert (r, c) == (0, 0)
    assert_same(got, f)


# an entry of each packed-family layout that beats every ``family_np`` one
TOP = {3: (9, 9, (5 << 28) | 9), 2: (100, (1 << 28) | 100), 1: (100,)}
FAMILY = {3: "packed", 2: "rank", 1: "rank1"}
# int32 values at the edges of every word the packed key encoding splits:
# the sign bit, the low 4 bits that cross into the next word, cls's range
EDGES = np.array([-(1 << 31), -(1 << 31) + 15, -(1 << 28) - 1, -(1 << 28), -17, -16, -1, 0,
                  1, 15, 16, (1 << 28) - 1, 1 << 28, (1 << 31) - 16, (1 << 31) - 1],
                 dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("nf", [3, 2, 1])
def test_pipe_key_preserves_order(nf):
    """The pipelined pass's key encoding (frontier.cuh PipeKey) of each
    packed-family layout: decode inverts encode, and the encoded compare
    (for packed, the borrow of a 96-bit subtract over the repacked words)
    agrees with the port's order on every pair of entries drawn from the
    edge values, where ties on the leading words are common."""
    rng = np.random.default_rng(40 + nf)
    key = PipeKey(FAMILY[nf])
    k = 4096
    f = [torch.from_numpy(rng.choice(EDGES, k)) for _ in range(nf)]
    g = [torch.from_numpy(rng.choice(EDGES, k)) for _ in range(nf)]
    for x, y in zip(key.decode(key.encode(f)), f):
        assert torch.equal(x, y)
    assert torch.equal(key.gt(key.encode(g), key.encode(f)), pk.packed_beats(g, f))
    assert torch.equal(key.gt(key.encode(f), key.encode(g)), pk.packed_beats(f, g))
    assert not key.gt(key.encode(f), key.encode(f)).any()


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("p", [1, 2, 3, 17, 64])
@pytest.mark.parametrize("wrap", [True, False])
def test_frontier_pipe_model_matches_xla_twin(nf, p, wrap):
    """#19 / #16 at m = 8 as the card runs it: the pipelined pass
    (frontier_pipe_kernel's schedule, with its p + 2 m extension and the
    ring's saved rows) against eight XLA rounds per stripe, rows and the
    whole ids array (ids, count, changed total, max last); the plain
    version too. Tiny rings (p <= 2 m) take every extension row mod p.
    Where p >= 17, stripe 0 settles in round 3 and leaves the frontier;
    stripe 2 is not in it."""
    n, tile, m = 512, 128, 8
    t_total = n // tile
    f = family_np(nf, p, n, 70 + 3 * p + nf)
    if p >= 17:
        for x, v in zip(f, TOP[nf]):
            x[:5, :tile] = v
            x[10:, :tile] = v
    ids = _ids(np.array([True, True, False, True]), m)
    want, ids_want = _frontier_xla_twin(f, ids.numpy(), tile, wrap, m)
    model = [torch.from_numpy(x.copy()) for x in f]
    ids_model = frontier_pipe_model(model, ids, tile, wrap, PipeKey(FAMILY[nf]), m)
    plain = [torch.from_numpy(x.copy()) for x in f]
    _, ids_plain = pk.frontier_round_packed(plain, ids, tile, wrap, m)
    count = int(ids_want[t_total])
    for got, ids_got in ((model, ids_model), (plain, ids_plain)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(ids_got.numpy()[:count], ids_want[:count])
        np.testing.assert_array_equal(ids_got.numpy()[t_total:], ids_want[t_total:])
    if p >= 17:
        assert 0 not in ids_want[:count].tolist()
