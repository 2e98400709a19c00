"""The port's rank layouts (bullet_tpu_torch/ops/rank.py) against the
reference's (bullet_tpu/ops/rank.py): the RankIndex (order, incremental
against bulk inserts, respread points, prev_inverse, the native insert),
the op reductions (native and numpy), the conversions and re-keys, and
every packed-family kernel's plain version at the rank (nf = 2) and rank1
(nf = 1) field counts: flat apply, ring and chain rounds, the count-only
probe, frontier steps and the reconcile, held against the reference's XLA
functions and its Pallas kernels in interpret mode. Tolerance: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu import native as ref_native
from bullet_tpu.ops import packed as jpk
from bullet_tpu.ops import rank as jrk
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch import _build
from bullet_tpu_torch import native as port_native
from bullet_tpu_torch.convert import FROM_NUMPY, table_to_numpy
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.ops import rank as rk
from _native_libs import load_native
from test_torch_packed import _check_step, _ids, assert_same, check_apply_model
from test_torch_rekey_rank1 import converged_table, luts, mixed_table, respread_index
from test_torch_window import JAX_TABLE, LAYOUT, fields_np

torch.set_num_threads(2)


def jt(fields):
    return JAX_TABLE[len(fields)](*(jnp.asarray(f) for f in fields))


def pt(fields):
    return FROM_NUMPY[LAYOUT[len(fields)]](fields, "cpu")


def world(rng, n_vals):
    """A value universe (cls, khi, klo) per vid with many key collisions
    across distinct vids (the bool-vs-number tie)."""
    return (rng.integers(1, 4, n_vals).astype(np.int32),
            rng.integers(-3, 3, n_vals).astype(np.int32),
            rng.integers(-3, 3, n_vals).astype(np.int32))


def index_state(idx):
    return (idx._svids, idx._sranks, idx._sk1, idx._sk2, idx.rank_map(),
            idx.epoch, idx.needs_rekey,
            None if idx.prev_inverse is None else tuple(idx.prev_inverse))


def assert_index_equal(port, ref):
    for a, b in zip(index_state(port), index_state(ref)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b


# ------------------------------------------------------------- RankIndex


def test_rank_index_order_matches_packed_chain():
    cls, khi, klo = world(np.random.default_rng(1), 200)
    port, ref = rk.RankIndex(), jrk.RankIndex()
    for idx in (port, ref):
        idx.insert_batch(np.arange(200), cls, khi, klo)
    assert_index_equal(port, ref)
    rmap = port.rank_map()
    by_key = sorted(range(200), key=lambda v: (cls[v], khi[v], klo[v], v))
    assert by_key == sorted(range(200), key=lambda v: rmap[v])
    assert rmap[by_key[0]] >= 1


@pytest.mark.parametrize("span", [None, 8191, 1023])
def test_rank_index_incremental_matches_reference(monkeypatch, span):
    """Batches of 17 (and the bulk insert of the same keys): the same
    ranks, epochs, respread points and prev_inverse as the reference, with
    the rank space shrunk on both sides so that gaps exhaust."""
    if span is not None:
        monkeypatch.setattr(rk, "RANK_SPAN", span)
        monkeypatch.setattr(jrk, "RANK_SPAN", span)
    cls, khi, klo = world(np.random.default_rng(2), 300)
    port, ref, bulk = rk.RankIndex(), jrk.RankIndex(), rk.RankIndex()
    epochs = []
    for s in range(0, 300, 17):
        e = min(s + 17, 300)
        for idx in (port, ref):
            idx.insert_batch(np.arange(s, e), cls[s:e], khi[s:e], klo[s:e])
        assert_index_equal(port, ref)
        epochs.append(port.epoch)
    bulk.insert_batch(np.arange(300), cls, khi, klo)
    by_key = sorted(range(300), key=lambda v: (cls[v], khi[v], klo[v], v))
    for idx in (port, bulk):
        rmap = idx.rank_map()
        assert sorted(range(300), key=lambda v: rmap[v]) == by_key
    if span == 1023:
        assert epochs[-1] > 1 and port.prev_inverse is not None


def test_rank_index_respread_on_exhausted_gap(monkeypatch):
    monkeypatch.setattr(rk, "RANK_SPAN", 63)
    monkeypatch.setattr(jrk, "RANK_SPAN", 63)
    port, ref = rk.RankIndex(), jrk.RankIndex()
    seen = False
    for idx in (port, ref):
        idx.insert_batch([0, 1], [1, 1], [0, 0], [0, 100])
    for i, mid in enumerate(range(1, 10)):
        for idx in (port, ref):
            idx.insert_batch([2 + i], [1], [0], [mid])
        assert_index_equal(port, ref)
        seen = seen or port.needs_rekey
    assert seen
    ranks = np.asarray([port.rank_of(v) for v in range(11)])
    np.testing.assert_array_equal(port.decode_ranks(ranks), np.arange(11))
    assert port.decode_ranks(np.asarray([0, 5, ranks[3] + 1])).tolist() == [-1, -1, -1]


def test_native_rank_insert_matches_numpy(monkeypatch):
    """The port's native sort-merge insert leaves the index bit-identical
    to its numpy path: arrays, ranks, respreads and prev_inverse."""
    if port_native.load() is None:
        pytest.skip("no C++ toolchain: the numpy path runs alone")
    rng = np.random.default_rng(41)
    orig = port_native.rank_insert_batch
    for span in (rk.RANK_SPAN, 8191, 127):
        monkeypatch.setattr(rk, "RANK_SPAN", span)
        fast, slow = rk.RankIndex(), rk.RankIndex()
        next_vid = 0
        for _ in range(4):
            k = int(rng.integers(1, 200))
            vids = np.arange(next_vid, next_vid + k, dtype=np.int64)
            next_vid += k
            if rng.random() < 0.3:
                vids = rng.permutation(vids)
            keys = (rng.integers(1, 4, k), rng.integers(-3, 3, k), rng.integers(-2, 2, k))
            monkeypatch.setattr(port_native, "rank_insert_batch", orig)
            fast.insert_batch(vids, *keys)
            monkeypatch.setattr(port_native, "rank_insert_batch", lambda *a, **kw: None)
            slow.insert_batch(vids, *keys)
            assert_index_equal(fast, slow)


@pytest.mark.parametrize("native", [True, False])
def test_reduce_flat_ops_rank_matches_reference(native, monkeypatch):
    """The port's reduction (native pass, and the numpy body) gives the
    reference's winners in (peer, slot) order."""
    if not native:
        monkeypatch.setattr(port_native, "reduce_flat_ops_rank", lambda *a: NotImplemented)
    elif any(load_native(lib, monkeypatch) is None for lib in (port_native, ref_native)):
        pytest.skip("no C++ toolchain: the numpy fallbacks run")
    rng = np.random.default_rng(40)
    k, p, n = 20_000, 32, 2048
    peer = rng.integers(0, p, k).astype(np.int32)
    slot = rng.integers(0, n, k).astype(np.int32)
    rank = rng.integers(0, 1 << 30, k).astype(np.int32)
    cls = rng.integers(0, 4, k).astype(np.int64)
    cv = ((cls << pk.CV_SHIFT) | rng.integers(0, 1 << 20, k)).astype(np.int32)
    want = jrk.reduce_flat_ops_rank(peer, slot, rank, cv)
    got = rk.reduce_flat_ops_rank(peer, slot, rank, cv)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    z = np.zeros(4, np.int32)
    assert rk.reduce_flat_ops_rank(z, z, z, z) is None  # no live op


# ------------------------------------------------- conversions, re-keys


def test_conversions_match_reference():
    rng = np.random.default_rng(9)
    cls, khi, klo = world(rng, 50)
    ref, port = jrk.RankIndex(), rk.RankIndex()
    for idx in (ref, port):
        idx.insert_batch(np.arange(50), cls, khi, klo)
    p, n = 4, 128
    vid = rng.integers(0, 50, (p, n))
    present = rng.random((p, n)) < 0.5
    packed = [np.where(present, khi[vid], 0).astype(np.int32),
              np.where(present, klo[vid], 0).astype(np.int32),
              np.where(present, (cls[vid].astype(np.int64) << 28) | vid, 0).astype(np.int32)]
    rmap, sranks, svids = ref.rank_map(), *ref.inverse_arrays()
    t = lambda a: torch.from_numpy(np.asarray(a))

    want = jrk.pack_to_rank(jt(packed), jnp.asarray(rmap))
    got = rk.pack_to_rank(pt(packed), t(port.rank_map()))
    assert_same(got, want)
    assert_same(rk.rank_to_packed(got, t(khi), t(klo)),
                jrk.rank_to_packed(want, jnp.asarray(khi), jnp.asarray(klo)))
    want1 = jrk.pack_to_rank1(jt(packed), jnp.asarray(rmap))
    got1 = rk.pack_to_rank1(pt(packed), t(port.rank_map()))
    assert_same(got1, want1)
    assert_same(rk.rank_to_rank1(got), want1)
    back = rk.rank1_to_rank(got1, *(t(a) for a in port.inverse_arrays()), t(cls))
    assert_same(back, jrk.rank1_to_rank(want1, jnp.asarray(sranks), jnp.asarray(svids),
                                        jnp.asarray(cls)))
    np.testing.assert_array_equal(back.cv.numpy(), packed[2])
    # the decode, with stale ranks (present in no inverse) reading absent
    probe = np.concatenate([table_to_numpy(got1)[0].ravel(), [0, 1, 7, sranks[5] + 1]])
    probe = probe.astype(np.int32)
    ok_w, vid_w = jrk.decode_vids_rank1(jnp.asarray(probe), jnp.asarray(sranks), jnp.asarray(svids))
    ok_g, vid_g = rk.decode_vids_rank1(t(probe), *(t(a) for a in port.inverse_arrays()))
    np.testing.assert_array_equal(ok_g.numpy(), np.asarray(ok_w))
    np.testing.assert_array_equal(vid_g.numpy()[ok_g.numpy()], np.asarray(vid_w)[np.asarray(ok_w)])
    host = port.decode_ranks(probe)
    np.testing.assert_array_equal(host >= 0, ok_g.numpy())
    np.testing.assert_array_equal(host[host >= 0], vid_g.numpy()[host >= 0])


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_rekey_after_respread_matches_reference(monkeypatch, layout):
    """A table ranked under one epoch, re-keyed after a respread: through
    cv (rank) or through prev_inverse (rank1), as the reference does."""
    monkeypatch.setattr(rk, "RANK_SPAN", 1023)
    monkeypatch.setattr(jrk, "RANK_SPAN", 1023)
    ref, port = jrk.RankIndex(), rk.RankIndex()
    for idx in (ref, port):
        idx.insert_batch(np.arange(3), np.array([2, 2, 2]), np.array([0, 10, 20]), np.zeros(3))
    rng = np.random.default_rng(11)
    p, n = 2, 64
    vid = rng.integers(0, 3, (p, n))
    present = rng.random((p, n)) < 0.7
    rank0 = np.where(present, port.rank_map()[vid], 0).astype(np.int32)
    cv = np.where(present, (2 << 28) | vid, 0).astype(np.int32)
    epoch0, v = port.epoch, 3
    while port.epoch == epoch0:
        for idx in (ref, port):
            idx.insert_batch(np.array([v]), np.array([2]), np.array([1]), np.array([v]))
        v += 1
        assert v < 2000, "respread never fired"
    assert_index_equal(port, ref)
    t = lambda a: torch.from_numpy(np.asarray(a))
    if layout == "rank":
        want = jrk.rekey_rank(jt([rank0, cv]), jnp.asarray(ref.rank_map()))
        got = rk.rekey_rank(pt([rank0, cv]), t(port.rank_map()))
    else:
        osr, osv = ref.prev_inverse
        want = jrk.rekey_rank1(jt([rank0]), jnp.asarray(osr), jnp.asarray(osv),
                               jnp.asarray(ref.rank_map()))
        got = rk.rekey_rank1(pt([rank0]), *(t(a) for a in port.prev_inverse),
                             t(port.rank_map()))
    assert_same(got, want)
    np.testing.assert_array_equal(got.rank.numpy(), np.where(present, port.rank_map()[vid], 0))


@pytest.mark.parametrize("case", ["uniform", "mixed", "ragged", "shard", "empty"])
def test_rekey_rank1_shapes_match_reference(case):
    """The plain re-key of a rank1 table, on the shapes the card's kernel
    takes (``test_torch_rekey_rank1.py``) in small form, against the
    reference's ``rekey_rank1``, after a real respread of both indexes:
    uniform columns as a converge leaves them, mixed columns that are not
    converged (ranks the old inverse lacks, 0, negatives), a ragged width,
    a shard's rows, and an empty inverse (the reference's gather refuses
    one; its host decode reads every rank as absent). A CPU table launches
    nothing and counts no search."""
    port = respread_index(np.random.default_rng(7), 300)
    ref = respread_index(np.random.default_rng(7), 300, jrk.RankIndex)
    assert_index_equal(port, ref)
    inverse = luts(port, "cpu")
    gen = torch.Generator()
    gen.manual_seed(26)
    p, n = (12, 61) if case == "ragged" else (16, 64)
    make = converged_table if case in ("uniform", "shard") else mixed_table
    rank = make(gen, inverse[0], p, n)
    if case == "shard":
        rank = rank[4:8].contiguous()
    if case == "empty":
        inverse[:2] = [torch.zeros(0, dtype=torch.int32)] * 2
        assert (jrk.RankIndex().decode_ranks(rank.numpy()) < 0).all()
        want = np.zeros_like(rank.numpy())
    else:
        want = np.asarray(jrk.rekey_rank1(jt([rank.numpy()]), *(jnp.asarray(a.numpy())
                                                             for a in inverse)).rank)
    launches = _build.LAUNCHES["rekey_rank1"]
    got = rk.rekey_rank1(rk.Rank1Table(rank.clone()), *inverse)
    np.testing.assert_array_equal(got.rank.numpy(), want)
    assert _build.LAUNCHES["rekey_rank1"] == launches
    assert torch.device("cpu") not in rk._REKEY_SEARCHES


# ------------------------------------- the kernels at nf = 1 and nf = 2


def rank_ops(rng, p, n, k):
    peer = rng.integers(0, p, k).astype(np.int32)
    slot = rng.integers(0, n, k).astype(np.int32)
    rank = rng.integers(0, 1 << 30, k).astype(np.int32)
    cv = np.where(rank > 0, (1 << 28) | (rank & pk.VID_MASK), 0).astype(np.int32)
    return peer, slot, rank, cv


@pytest.mark.parametrize("nf", [1, 2])
def test_flat_apply_matches_reference(nf):
    """The flat apply against the reference's scatter apply and its
    chunk-grid kernel (#9, interpret mode); out-of-range ops dropped."""
    p, n = 16, 1024
    rng = np.random.default_rng(7 + nf)
    raw = rank_ops(rng, p, n, 600)
    base = fields_np(nf, p, n, seed=7)
    reduced = rk.reduce_flat_ops_rank(*raw)
    if nf == 1:
        want, a_want = jrk.apply_flat_rank1(jt(base), *(jnp.asarray(a) for a in reduced[:3]))
        got, a_got = rk.apply_flat_rank1_stacked(pt(base), torch.from_numpy(np.stack(reduced[:3])))
    else:
        want, a_want = jrk.apply_flat_rank(jt(base), *(jnp.asarray(a) for a in reduced))
        got, a_got = rk.apply_flat_rank(pt(base), *(torch.from_numpy(a) for a in reduced))
    assert_same(got, want)
    assert int(a_got) == int(a_want) > 0
    blocked = jrk.reduce_flat_ops_rank(*raw, block_shape=(p, n))[:nf + 2]
    chunked, a_chunked = jpk.apply_flat_blocked(jt(base), *jpk.chunk_block_ops(*blocked, p, n))
    assert_same(got, chunked)
    assert int(a_got) == int(a_chunked)
    # an op past the table never lands
    stray = torch.tensor([[p], [0], [1 << 29], [(1 << 28) | 1]], dtype=torch.int32)[: nf + 2]
    again, a_stray = pk.apply_flat_packed(got, stray)
    assert int(a_stray) == 0


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("nf", [1, 2])
def test_apply_model_matches_reference(nf, order):
    """#9/#10 at nf = 2 and 1: the CUDA kernel's schedule (apply_model: the
    rank alone read) on sorted and shuffled ops with dead values (rank 0),
    ties and out-of-range rows, against the reference's flat apply."""
    check_apply_model(nf, order, 10 + nf)


@pytest.mark.parametrize("nf", [1, 2])
@pytest.mark.parametrize("wrap", [True, False])
def test_rounds_and_probe_match_reference(nf, wrap):
    """One round (XLA and the full-P stripe kernel #13 in interpret mode),
    m = 3 fused rounds (#11), and the count-only probe (#14)."""
    f = fields_np(nf, 16, 512, seed=nf)
    xla = jpk.gossip_round_ring_packed if wrap else jpk.gossip_round_chain_packed
    want, c_want = xla(jt(f))
    pallas, c_pallas = jpk.ring_round_packed_traced(jt(f), wrap, True)
    got, c_got = pk.ring_round_packed(pt(f), wrap)
    for ref, c_ref in ((want, c_want), (pallas, c_pallas)):
        assert_same(got, ref)
        assert int(c_got) == int(c_ref)
    fused, c_fused = jpk.ring_multiround_packed_traced(jt(f), wrap, 3, True)
    got3, c_got3 = pk.ring_multiround_packed(pt(f), wrap, 3)
    assert_same(got3, fused)
    assert int(c_got3) == int(c_fused)
    before = pt(f)
    probe = pk.count_changes_round_packed(before, wrap)
    assert int(probe) == int(jpk.count_changes_round_packed(jt(f), wrap, True)) == int(c_want)
    assert_same(before, f)  # the probe wrote nothing


@pytest.mark.parametrize("nf", [1, 2])
def test_big_p_round_matches_halo_kernel(nf):
    """P = 4096: the reference's halo round (#27) in interpret mode."""
    f = fields_np(nf, 4096, 128, seed=11)
    want, c_want = jax.jit(jpk.halo_round_packed_traced, static_argnums=(1, 2))(jt(f), True, True)
    got, c_got = pk.ring_round_packed(pt(f), True)
    assert_same(got, want)
    assert int(c_got) == int(c_want)


@pytest.mark.parametrize("nf,m,wrap", [(1, 1, True), (2, 1, False), (1, 4, False), (2, 4, True)])
def test_frontier_step_matches_pallas_interpret(nf, m, wrap):
    """One compacting step where both packages stripe at 256: #20 (m = 1)
    and #19 (m = 4) in interpret mode, every other stripe active."""
    p, n = 512, 1024
    tile = pk.frontier_tile_n(n)
    assert tile == jpk.frontier_tile_n(p, n) == 256
    t_total = n // tile
    f = fields_np(nf, p, n, seed=5)
    ids = _ids(np.arange(t_total) % 2 == (m % 2), m)
    if m == 1:
        want, ids_want = jpk.frontier_round_packed_traced(jt(f), jnp.asarray(ids.numpy()), wrap, True)
    else:
        want, ids_want = jpk.frontier_multiround_packed_traced(
            jt(f), jnp.asarray(ids.numpy()), wrap, m, True)
    got, ids_got = pk.frontier_round_packed(pt(f), ids, tile, wrap, m)
    _check_step(got, ids_got, want, ids_want, t_total)


@pytest.mark.parametrize("nf", [1, 2])
def test_frontier_loop_and_reconcile_match_reference(nf):
    """The frontier loop reaches the reference's classic fixed point and
    round count; the reconcile equals the reference's doubling join (XLA
    and the stripe kernel #15) and that fixed point."""
    p, n = 24, 512
    f = fields_np(nf, p, n, seed=3)
    want, r_want, c_want = jpk.gossip_until_converged_packed(
        jt(f), jnp.asarray(jax_topo.ring(p).neighbors), "ring", 40)
    t_total = n // pk.frontier_tile_n(n)
    got, r_got, c_got = pk.gossip_frontier_packed(pt(f), torch.ones(t_total, dtype=torch.bool),
                                                  True, 40)
    assert_same(got, want)
    assert (r_got, c_got) == (int(r_want), int(c_want)) and c_got == 0
    rec = pk.reconcile_packed(pt(f))
    assert_same(rec, jpk.reconcile_packed_xla(jt(f)))
    assert_same(rec, jax.jit(jpk.reconcile_packed_traced, static_argnums=(1,))(jt(f), True))
    assert_same(rec, want)
