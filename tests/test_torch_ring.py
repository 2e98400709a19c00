"""Port ring round and dense frontier against the reference: ring_round
and frontier_round_dense_traced in Pallas interpret mode, the XLA ring and
chain rounds, and the classic convergence loop. Tolerance: exact (int32
fields, counts, ids, rounds and residuals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.ops.ring_kernel import (
    frontier_round_dense_traced,
    frontier_tile_n_dense as jax_frontier_tile,
    ring_round_pallas,
)
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu.parallel.gossip import (
    gossip_round_chain,
    gossip_round_ring,
    gossip_until_converged_device,
)
from bullet_tpu_torch.convert import table_from_numpy, table_to_numpy
from bullet_tpu_torch.ops.packed import frontier_ids_compact
from bullet_tpu_torch.ops.ring_kernel import (
    beats_of,
    frontier_round_dense,
    frontier_round_dense_torch,
    frontier_tile_n,
    gossip_frontier_dense,
    ring_round,
    ring_round_torch,
)

from _kernel_models import PipeKey, frontier_pipe_model

torch.set_num_threads(2)

RANGES = ((0, 4), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 4), (0, 5))


def fields(seed, p, n):
    """Many ties, negative khi/klo, cls=0 entries with nonzero fields."""
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, (p, n), dtype=np.int32) for lo, hi in RANGES]


def sparse_fields(seed, p, n):
    """Absent-heavy table (present entries only where cls > 0), so rounds
    keep changing for about diameter rounds."""
    rng = np.random.default_rng(seed)
    cls = (rng.random((p, n)) < 0.05) * rng.integers(1, 4, (p, n))
    present = cls > 0

    def m(lo, hi):
        return np.where(present, rng.integers(lo, hi, (p, n)), 0).astype(np.int32)

    return [cls.astype(np.int32), m(-50, 50), m(-50, 50), m(0, 30),
            m(0, p), m(0, 9), m(0, 5)]


def assert_tables_equal(port, ref):
    for a, b in zip(table_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("p", [1, 2, 3, 8, 64])
def test_ring_round_matches_reference(p, wrap, mode):
    n = 128 if p % 8 == 0 else 130
    t = fields(p * 31 + n, p, n)
    xla = gossip_round_ring if wrap else gossip_round_chain
    want, c_want = xla(JaxTable(*t), mode)
    refs = [(want, c_want)]
    if p % 8 == 0:
        refs.append(ring_round_pallas(JaxTable(*t), mode=mode, wrap=wrap, interpret=True))
    for fn in (ring_round, ring_round_torch):
        got, c_got = fn(table_from_numpy(t, "cpu"), mode, wrap)
        for ref, c_ref in refs:
            assert_tables_equal(got, ref)
            assert int(c_got) == int(c_ref)


def test_chain_end_zero_row_is_compared():
    """A cls=0 entry with khi < 0 at a chain end loses to the missing
    (all-zero) neighbour, and the count records it."""
    t = [np.zeros((2, 1), np.int32) for _ in range(7)]
    t[1][0, 0] = -5
    got, c = ring_round(table_from_numpy(t, "cpu"), "reference", wrap=False)
    want, c_want = gossip_round_chain(JaxTable(*t), "reference")
    assert_tables_equal(got, want)
    assert int(c) == int(c_want) == 1


def _ids_array(flags, m):
    t_total = len(flags)
    ids = np.zeros(t_total + (3 if m > 1 else 2), np.int32)
    k = int(flags.sum())
    ids[:k] = np.flatnonzero(flags)
    ids[t_total] = k
    ids[t_total + 1] = 1
    return ids


def _check_frontier(t, ids, tile, wrap, mode, m, want, ids_want):
    t_total = len(ids) - (3 if m > 1 else 2)
    count = int(ids_want[t_total])
    for fn in (frontier_round_dense, frontier_round_dense_torch):
        got, ids_got = fn(table_from_numpy(t, "cpu"), torch.from_numpy(ids.copy()),
                          tile, wrap, mode, m)
        ids_got = ids_got.numpy()
        assert_tables_equal(got, want)
        # cells past the count are unspecified
        np.testing.assert_array_equal(ids_got[:count], ids_want[:count])
        np.testing.assert_array_equal(ids_got[t_total:], ids_want[t_total:])


# m = 8 is not compiled in interpret mode here: XLA:CPU takes minutes to
# compile the eight unrolled interpret-mode rounds even at 8 x 128, so the
# fused case is held against its XLA twin below and m = 4 against Pallas.
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("wrap,mode,dirty", [
    (True, "reference", "all"), (False, "lww", "sparse"),
])
def test_frontier_round_matches_pallas_interpret(m, wrap, mode, dirty):
    p, n = 256, 1024
    tile = jax_frontier_tile(p, n, False)
    t_total = n // tile
    assert t_total == 4
    flags = np.ones(t_total, bool) if dirty == "all" else np.arange(t_total) % 2 == 1
    ids = _ids_array(flags, m)
    t = sparse_fields(5, p, n)
    want, ids_want = frontier_round_dense_traced(
        JaxTable(*(jnp.asarray(f) for f in t)), jnp.asarray(ids), wrap, mode,
        False, True, m=m,
    )
    _check_frontier(t, ids, tile, wrap, mode, m, want, np.asarray(ids_want))
    if m > 1:
        # the pipelined pass's schedule at depth m
        _check_pipe_model(t, ids, tile, wrap, mode, m, want, np.asarray(ids_want))


def _check_pipe_model(t, ids, tile, wrap, mode, m, want, ids_want, nf=7):
    t_total = len(ids) - (3 if m > 1 else 2)
    count = int(ids_want[t_total])
    got = [torch.from_numpy(f.copy()) for f in t[:nf]]
    ids_got = frontier_pipe_model(got, torch.from_numpy(ids.copy()), tile, wrap,
                                  PipeKey("lean" if nf == 4 else mode), m).numpy()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ids_got[:count], ids_want[:count])
    np.testing.assert_array_equal(ids_got[t_total:], ids_want[t_total:])


def _frontier_xla_twin(t, ids, tile, wrap, mode, m):
    """m classic XLA rounds on each active stripe's columns; the next ids
    array from the per-stripe round counts."""
    t_total = t[0].shape[1] // tile
    count = int(ids[t_total])
    xla = gossip_round_ring if wrap else gossip_round_chain
    out = [f.copy() for f in t]
    keep, changed, max_last = [], 0, 0
    for s in ids[:count]:
        cols = slice(s * tile, (s + 1) * tile)
        sub = JaxTable(*(jnp.asarray(f[:, cols]) for f in out))
        last = 0
        for k in range(1, m + 1):
            sub, c = xla(sub, mode)
            changed += int(c)
            if int(c):
                last = k
        for f, g in zip(out, sub):
            f[:, cols] = np.asarray(g)
        max_last = max(max_last, last)
        if last == m:
            keep.append(s)
    ids_out = np.zeros(len(ids), np.int32)
    ids_out[: len(keep)] = keep
    ids_out[t_total] = len(keep)
    ids_out[t_total + 1] = changed
    if m > 1:
        ids_out[t_total + 2] = max_last
    return out, ids_out


@pytest.mark.parametrize("wrap,mode,dirty,seed", [
    (True, "reference", "all", 5), (False, "reference", "sparse", 6),
    (True, "lww", "sparse", 7), (False, "lww", "all", 8),
])
def test_frontier_round_fused_matches_xla_twin(wrap, mode, dirty, seed):
    p, n, m = 24, 1024, 8
    tile = frontier_tile_n(n)
    t_total = n // tile
    flags = np.ones(t_total, bool) if dirty == "all" else np.arange(t_total) % 2 == 0
    ids = _ids_array(flags, m)
    t = sparse_fields(seed, p, n)
    want, ids_want = _frontier_xla_twin(t, ids, tile, wrap, mode, m)
    _check_frontier(t, ids, tile, wrap, mode, m, want, ids_want)


def test_frontier_tile_n_dense():
    assert frontier_tile_n(1 << 18) == 256
    assert frontier_tile_n(96) == 96
    assert frontier_tile_n(1000) == 0  # no multiple of 32 divides it
    assert frontier_tile_n(4160) == 160
    for n in (32, 64, 4160, 1 << 12):
        t = frontier_tile_n(n)
        assert t % 32 == 0 and n % t == 0 and t <= 256


def test_frontier_ids_compact_layout():
    ids = frontier_ids_compact(torch.tensor([False, True, True, False, True]), 5)
    assert ids.tolist() == [1, 2, 4, 0, 0, 3, 1]


@pytest.mark.parametrize(
    "fuse,max_rounds,wrap,mode,tile",
    [
        (1, 18, True, "reference", None),
        (8, 18, True, "reference", None),
        (8, 18, False, "reference", 1024),  # the reference's stripe width
        (8, 3, True, "reference", None),  # cutoff inside the tail
        (8, 12, True, "lww", None),  # cutoff after a fused step
        (1, 5, False, "lww", None),
        (3, 17, False, "reference", 64),  # fuse that does not divide
    ],
)
def test_gossip_frontier_dense_matches_classic_loop(fuse, max_rounds, wrap, mode, tile):
    p, n = 16, 1024
    t = sparse_fields(21, p, n)
    kind = "ring" if wrap else "chain"
    nb = jnp.asarray(getattr(jax_topo, kind)(p).neighbors)
    want, r_want, c_want = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in t)), nb, kind, mode, max_rounds,
    )
    tile_n = tile or frontier_tile_n(n)
    got, r_got, c_got = gossip_frontier_dense(
        table_from_numpy(t, "cpu"), torch.ones(n // tile_n, dtype=torch.bool),
        wrap, mode, max_rounds, fuse=fuse, tile_n=tile_n,
    )
    assert_tables_equal(got, want)
    assert r_got == int(r_want)
    assert c_got == int(c_want)


def test_gossip_frontier_dense_sparse_seed():
    """From a converged table, dirtying one stripe converges with only that
    stripe seeded — same state and rounds as the classic loop."""
    p, n = 16, 1024
    tile = frontier_tile_n(n)
    t = sparse_fields(10, p, n)
    nb = jnp.asarray(jax_topo.ring(p).neighbors)
    base, _, _ = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in t)), nb, "ring", "reference", p + 2
    )
    upd = [np.array(f) for f in base]
    upd[0][5, tile + 3] = 3
    upd[1][5, tile + 3] = 10**9
    want, r_want, _ = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in upd)), nb, "ring", "reference", p + 2
    )
    dirty = torch.zeros(n // tile, dtype=torch.bool)
    dirty[1] = True
    got, r_got, c_got = gossip_frontier_dense(
        table_from_numpy(upd, "cpu"), dirty, True, "reference", p + 2
    )
    assert_tables_equal(got, want)
    assert r_got == int(r_want) and c_got == 0


def test_gossip_frontier_dense_nothing_dirty():
    t = table_from_numpy(fields(1, 8, 256), "cpu")
    before = table_to_numpy(t)
    got, rounds, changed = gossip_frontier_dense(
        t, torch.zeros(1, dtype=torch.bool), True, "reference", 10, fuse=8
    )
    assert (rounds, changed) == (0, 0)
    assert_tables_equal(got, before)


@pytest.mark.parametrize("nf,mode", [(7, "reference"), (7, "lww"), (4, "reference")])
@pytest.mark.parametrize("p", [1, 2, 3, 17, 64])
@pytest.mark.parametrize("wrap", [True, False])
def test_frontier_pipe_model_matches_xla_twin(nf, mode, p, wrap):
    """#8 at m = 8 as the card runs it: the pipelined pass
    (frontier_pipe_kernel's schedule) against eight XLA rounds per stripe,
    rows and the whole ids array, at nf = 7 (reference and lww) and 4
    (lean: the value keys, with writer, ctr and tick zero so the 7-field
    XLA round merges as the lean one does); the plain version too. Where
    p >= 17, stripe 0 settles in round 3 and leaves the frontier; stripe 2
    is not in it."""
    n, tile, m = 512, 128, 8
    t_total = n // tile
    t = fields(90 + 3 * p + nf, p, n)
    if nf == 4:
        t[4:] = [np.zeros((p, n), np.int32) for _ in range(3)]
    if p >= 17:
        for f in t[:nf]:
            f[:5, :tile] = 9
            f[10:, :tile] = 9
    ids = _ids_array(np.array([True, True, False, True]), m)
    want, ids_want = _frontier_xla_twin(t, ids, tile, wrap, mode, m)
    _check_pipe_model(t, ids, tile, wrap, mode, m, want, ids_want, nf)
    got, ids_got = frontier_round_dense(table_from_numpy(t, "cpu"), torch.from_numpy(ids.copy()),
                                        tile, wrap, mode, m, lean=nf == 4)
    assert_tables_equal(got, want)
    count = int(ids_want[t_total])
    np.testing.assert_array_equal(ids_got.numpy()[:count], ids_want[:count])
    np.testing.assert_array_equal(ids_got.numpy()[t_total:], ids_want[t_total:])
    if p >= 17:
        assert 0 not in ids_want[:count].tolist()


@pytest.mark.parametrize("nf,mode", [(7, "reference"), (7, "lww"), (4, "reference")])
def test_pipe_key_preserves_order(nf, mode):
    """The pipelined pass's key encoding (frontier.cuh PipeKey) of the
    dense layouts: decode inverts encode (tick carried as is), and the
    borrow of the subtract over the biased key words agrees with the port's
    order on every pair of entries drawn from int32 edge values, where
    ties on the leading words are common."""
    rng = np.random.default_rng(nf + len(mode))
    key = PipeKey("lean" if nf == 4 else mode)
    edges = np.array([-(1 << 31), -(1 << 31) + 1, -1, 0, 1, (1 << 31) - 2, (1 << 31) - 1],
                     dtype=np.int64).astype(np.int32)
    k = 4096
    f = [torch.from_numpy(rng.choice(edges, k)) for _ in range(nf)]
    g = [torch.from_numpy(rng.choice(edges, k)) for _ in range(nf)]
    beats = beats_of(nf, mode)
    for x, y in zip(key.decode(key.encode(f)), f):
        assert torch.equal(x, y)
    assert torch.equal(key.gt(key.encode(g), key.encode(f)), beats(g, f))
    assert torch.equal(key.gt(key.encode(f), key.encode(g)), beats(f, g))
    assert not key.gt(key.encode(f), key.encode(f)).any()
