"""Lean gossip in the port against the reference: the lean round against
ring_round_pallas_lean in Pallas interpret mode (full-P and halo shapes),
the lean frontier against the reference's lean gossip_frontier_dense, the
route predicates (lean round, frontier available) on every shape class,
and lean sims (the kernel routes, and the plain full-metadata rounds)
against the reference's. Tolerance: exact (int32 fields, counts, rounds,
residuals and reads)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.ops import ring_kernel as ref_rk
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_from_numpy, table_to_numpy
from bullet_tpu_torch.ops.merge import lean_fields, merge_lean, merge_lean_torch
from bullet_tpu_torch.ops.ring_kernel import (
    dense_frontier_available,
    dense_frontier_available_sharded,
    frontier_tile_n,
    gossip_frontier_dense,
    lean_supported,
    ring_round_lean,
    ring_round_lean_torch,
)
from bullet_tpu_torch.parallel import topology as topo

torch.set_num_threads(2)


def sparse_fields(seed, p, n):
    """Absent-heavy table (present entries only where cls > 0), so rounds
    keep changing for about diameter rounds; metadata random."""
    rng = np.random.default_rng(seed)
    cls = (rng.random((p, n)) < 0.05) * rng.integers(1, 4, (p, n))
    present = cls > 0

    def m(lo, hi):
        return np.where(present, rng.integers(lo, hi, (p, n)), 0).astype(np.int32)

    return [cls.astype(np.int32), m(-50, 50), m(-50, 50), m(0, 30),
            m(0, p), m(0, 9), m(0, 5)]


def dense_fields(seed, p, n):
    """Many ties, negative keys, cls = 0 entries with nonzero fields."""
    rng = np.random.default_rng(seed)
    ranges = ((0, 4), (-50, 50), (-50, 50), (0, 30), (0, 8), (0, 9), (0, 5))
    return [rng.integers(lo, hi, (p, n), dtype=np.int32) for lo, hi in ranges]


def assert_fields_equal(port, ref, what=""):
    for name, a, b in zip(("cls", "khi", "klo", "vid", "writer", "ctr", "tick"),
                          table_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b), f"{name} {what}")


# ------------------------------------------------------------ lean round


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("shape", [(1536, 256), (1024, 256), (16, 128), (12, 130)])
def test_lean_round_matches_pallas_interpret(shape, wrap):
    """(1536, 256) takes the reference's halo kernel (#5), (1024, 256) and
    (16, 128) its full-P kernel (#4); (12, 130) no lean kernel at all
    (the port's kernel takes any shape; the sims never route it there)."""
    p, n = shape
    t = dense_fields(p + n, p, n)
    assert ref_rk.lean_supported(p, n) == (n % 128 == 0)
    if n % 128 == 0:
        want, c_want = ref_rk.ring_round_pallas_lean(
            JaxTable(*(jnp.asarray(f) for f in t)), wrap=wrap, interpret=True)
    else:  # the reference's lean merge in XLA: the value keys of its round
        from bullet_tpu.parallel.gossip import gossip_round_chain, gossip_round_ring

        full, _ = (gossip_round_ring if wrap else gossip_round_chain)(
            JaxTable(*(jnp.asarray(f) for f in t)), "reference")
        want, c_want = JaxTable(*full[:4], *t[4:]), None
    for fn in (ring_round_lean, ring_round_lean_torch):
        got, c_got = fn(table_from_numpy(t, "cpu"), wrap)
        assert_fields_equal(got, want, fn.__name__)
        if c_want is not None:
            assert int(c_got) == int(c_want)


def test_lean_merge_in_place():
    a, b = dense_fields(1, 9, 70), dense_fields(2, 9, 70)
    ta, tb = table_from_numpy(a, "cpu"), table_from_numpy(b, "cpu")
    twin = table_from_numpy(a, "cpu")
    c = merge_lean(lean_fields(ta), lean_fields(tb))
    c_plain = merge_lean_torch(lean_fields(twin), lean_fields(tb))
    ka, kb = np.stack(a[:4]), np.stack(b[:4])
    gt = np.zeros(ka.shape[1:], bool)
    eq = np.ones(ka.shape[1:], bool)
    for x, y in zip(ka, kb):
        gt |= eq & (y > x)
        eq &= x == y
    want = [np.where(gt, y, x) for x, y in zip(ka, kb)] + a[4:]
    assert_fields_equal(ta, want)
    assert_fields_equal(twin, want)
    assert int(c) == int(c_plain) == int(gt.sum())


# ------------------------------------------------------ route predicates

SHAPES = [(p, n) for p in (1, 3, 8, 12, 16, 24, 1000, 1024, 1032, 2048, 2056, 4096)
          for n in (64, 96, 128, 200, 256, 384, 1024, 4096)]


def test_lean_and_frontier_predicates_match_reference():
    for p, n in SHAPES:
        assert lean_supported(p, n) == ref_rk.lean_supported(p, n), (p, n)
        for lean in (False, True):
            assert dense_frontier_available(p, n, lean) == (
                ref_rk.frontier_tile_n_dense(p, n, lean) > 0), (p, n, lean)
            for k in (1, 2, 4, 8):
                assert dense_frontier_available_sharded(p, n, k, lean) == (
                    ref_rk.frontier_tile_n_dense_sharded(p, n, k, lean) > 0), (p, n, k, lean)


# ------------------------------------------------------- lean frontier


@pytest.fixture(scope="module")
def reference_lean_frontier():
    """The reference's lean gossip_frontier_dense (interpret mode, fuse 1)
    on the frontier cases, computed once: {(wrap, max_rounds, seed):
    (fields, rounds, last_changed)}."""
    p, n = 16, 512
    out = {}
    for wrap, max_rounds in ((True, 18), (True, 7), (False, 12), (False, 18)):
        t = sparse_fields(21, p, n)
        got, r, c = ref_rk.gossip_frontier_dense(
            JaxTable(*(jnp.asarray(f) for f in t)), jnp.ones(1, bool), wrap, "reference",
            True, max_rounds, interpret=True, fuse=1)
        out[wrap, max_rounds] = (t, [np.asarray(f) for f in got], int(r), int(c))
    return out


@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("wrap,max_rounds", [(True, 18), (True, 7), (False, 12), (False, 18)])
def test_lean_frontier_matches_reference(reference_lean_frontier, wrap, max_rounds, fuse):
    """Converging (18 > P + 1) and cut off mid-fuse (7) or in the tail
    (12); the port's own stripe width (4 stripes, the reference's one)."""
    t, want, r_want, c_want = reference_lean_frontier[wrap, max_rounds]
    tile = frontier_tile_n(512)
    got, r_got, c_got = gossip_frontier_dense(
        table_from_numpy(t, "cpu"), torch.ones(512 // tile, dtype=torch.bool), wrap,
        "reference", max_rounds, fuse=fuse, tile_n=tile, lean=True)
    assert_fields_equal(got, want)
    assert (r_got, c_got) == (r_want, c_want)
    # the lean contract: writer, ctr and tick untouched
    assert_fields_equal(got, [*want[:4], *t[4:]])


def test_lean_frontier_sparse_seed():
    """From a lean fixed point, one changed entry and one seeded stripe
    converge like the reference's lean loop from the whole table."""
    p, n = 16, 512
    tile = frontier_tile_n(n)
    nb = jnp.asarray(jax_topo.ring(p).neighbors)
    base, _, _ = ref_rk.gossip_frontier_dense(
        JaxTable(*(jnp.asarray(f) for f in sparse_fields(10, p, n))), jnp.ones(1, bool), True,
        "reference", True, p + 2, interpret=True)
    upd = [np.array(f) for f in base]
    upd[0][5, tile + 3] = 3
    upd[1][5, tile + 3] = 10**9
    from bullet_tpu.parallel.gossip import gossip_until_converged_device

    want, r_want, _ = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in upd)), nb, "ring", "reference", p + 2,
        use_pallas=True, lean=True)
    for fuse in (1, 8):
        dirty = torch.zeros(n // tile, dtype=torch.bool)
        dirty[1] = True
        got, r_got, c_got = gossip_frontier_dense(
            table_from_numpy(upd, "cpu"), dirty, True, "reference", p + 2, fuse=fuse,
            tile_n=tile, lean=True)
        assert_fields_equal(got, want)
        assert (r_got, c_got) == (int(r_want), 0)


# ------------------------------------------------------------ lean sims


def load(sim, seed, p, paths=40):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        sim.put(int(rng.integers(p)), f"k/v{int(rng.integers(paths))}", int(rng.integers(1000)))
    sim.put(0, "s/a", "pear")
    sim.put(p - 1, "s/a", "apple")
    sim.put(p // 2, "obj", {"x": 1, "y": {"z": "w"}})
    k = max(80, paths)
    sim.put_bulk(rng.integers(0, p, k), [f"b/{i}" for i in rng.integers(0, paths, k)],
                 rng.integers(-9, 9, k))


@pytest.mark.parametrize("topology,kernels", [
    ("ring", True), ("chain", True), ("ring", False), ("chain", False),
])
def test_lean_sim_matches_reference(topology, kernels):
    """Kernel routes: the lean round in step, the lean frontier; without
    them, the full-metadata rounds (as the reference's XLA route)."""
    p, n = 16, 256
    js = JaxSim(p, capacity=n, topology=topology, lean_gossip=True, use_pallas=kernels)
    ps = PeerNetworkSim(p, capacity=n, topology=topology, lean_gossip=True, device="cpu",
                        use_kernels=kernels)
    assert ps.lean_gossip and ps._convergence_strategy()[0] == (
        "dense-frontier" if kernels else "dense-loop")
    for s in (js, ps):
        load(s, 1, p)
    assert js.step(2) == ps.step(2)
    assert_fields_equal(ps.table, js.table)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert_fields_equal(ps.table, js.table)
    assert js.converged() == ps.converged()
    for s in (js, ps):
        load(s, 2, p, paths=400)  # past the capacity: the table grows
    assert js.run_until_converged(max_rounds=5) == ps.run_until_converged(max_rounds=5)
    assert js.last_residual == ps.last_residual
    assert_fields_equal(ps.table, js.table)
    for s in (js, ps):
        load(s, 3, p)
        s.reconcile()  # the lean doubling join
    assert ps.capacity == js.capacity > n
    assert_fields_equal(ps.table, js.table)
    for peer in (0, 7, p - 1):
        assert ps.get(peer) == js.get(peer)
    assert ps.get_bulk([1, 2, 3], ["s/a", "obj/y/z", "k/v3"]) == js.get_bulk(
        [1, 2, 3], ["s/a", "obj/y/z", "k/v3"])


@pytest.mark.parametrize("p,n,route", [
    (12, 256, "dense-loop"),  # P % 8: no frontier, the loop of lean rounds
    (16, 96, "dense-loop"),  # n % 128: no lean kernel, full rounds
    (16, 128, "dense-frontier"),
])
def test_lean_route_flips_match_reference(p, n, route):
    """Shapes where the reference's lean predicates flip: the port takes
    the same route, so the same fields move (the port's own stripe width
    would tile n = 96). Capacity growth (96 -> 384) flips the route back to
    the lean frontier."""
    js = JaxSim(p, capacity=n, topology="ring", lean_gossip=True, use_pallas=True)
    ps = PeerNetworkSim(p, capacity=n, topology="ring", lean_gossip=True, device="cpu",
                        use_kernels=True)
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == route
    for s in (js, ps):
        load(s, 4, p)
    assert js.step(1) == ps.step(1)
    assert js.run_until_converged() == ps.run_until_converged()
    assert_fields_equal(ps.table, js.table)
    for s in (js, ps):
        load(s, 5, p, paths=300)
    assert js.run_until_converged() == ps.run_until_converged()
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0]
    assert_fields_equal(ps.table, js.table)


def test_lean_weak_reconcile_and_snapshot_match_reference():
    """A partitioned topology reconciles by per-SCC closure joins of the
    value keys; a reference snapshot restores into a lean port sim."""
    rng = np.random.default_rng(7)
    adj = rng.random((10, 10)) < 0.15
    np.fill_diagonal(adj, False)
    js = JaxSim(10, capacity=64, topology=jax_topo.from_adjacency(adj), lean_gossip=True)
    ps = PeerNetworkSim(10, capacity=64, topology=topo.from_adjacency(adj), lean_gossip=True,
                        device="cpu")
    assert not ps.topology.is_connected()
    for s in (js, ps):
        load(s, 6, 10)
        s.reconcile()
    assert_fields_equal(ps.table, js.table)
    snap = js.snapshot()
    twin = PeerNetworkSim(10, capacity=64, topology=topo.from_adjacency(adj), lean_gossip=True,
                          device="cpu")
    load(twin, 6, 10)
    twin.restore(snap)
    assert_fields_equal(twin.table, js.table)
    assert twin.get(3) == js.get(3)


def test_lean_ignored_in_lww_mode():
    assert not PeerNetworkSim(8, lean_gossip=True, mode="lww", device="cpu").lean_gossip


@pytest.mark.parametrize("kind,max_rounds", [("ring", 18), ("chain", 6)])
def test_gossip_until_converged_lean_matches_reference(kind, max_rounds):
    """The port's round loop with lean=True (the kernel route's lean round)
    against the reference's device loop with use_pallas=True, lean=True."""
    from bullet_tpu.parallel.gossip import gossip_until_converged_device
    from bullet_tpu_torch.parallel.gossip import gossip_until_converged

    p, n = 16, 256
    t = sparse_fields(31, p, n)
    want, r_want, c_want = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in t)), jnp.asarray(getattr(jax_topo, kind)(p).neighbors),
        kind, "reference", max_rounds, use_pallas=True, lean=True)
    got, r_got, c_got = gossip_until_converged(
        table_from_numpy(t, "cpu"), getattr(topo, kind)(p), "reference", max_rounds, lean=True)
    assert_fields_equal(got, want)
    assert (r_got, c_got) == (int(r_want), int(c_want))
