"""The packed slice as a whole: the same puts go into a reference
PeerNetworkSim(layout="packed") (JAX, CPU) and the port's (device="cpu");
tables, applied counts, residuals, classic round counts, converged(),
reconcile and reads must be identical. Also the frontier's incremental
dirty-stripe bookkeeping, capacity growth, rekeying, weak-topology
reconcile, callbacks, and reference packed snapshots restored into the
port. Tolerance: exact."""

import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import packed_from_numpy, packed_to_numpy, table_to_numpy
from bullet_tpu_torch.parallel import topology as topo
from test_torch_netsim import P, paths_of, writes

torch.set_num_threads(2)


def assert_same(jax_sim, port_sim, msg=""):
    assert len(port_sim.table) == 3
    for a, b in zip(packed_to_numpy(port_sim.table), jax_sim.table):
        np.testing.assert_array_equal(a, np.asarray(b), msg)


def packed(p, capacity=256, topology="ring", **kw):
    return PeerNetworkSim(p, capacity=capacity, topology=topology, layout="packed",
                          device="cpu", **kw)


@pytest.mark.parametrize("topology,use_kernels", [
    ("ring", True), ("ring", False), ("chain", True), ("chain", False),
])
def test_packed_slice_matches_reference(topology, use_kernels):
    """put/put_bulk -> step -> run_until_converged (the frontier route or
    the whole-table loop) -> converged() -> reconcile -> get/get_bulk."""
    js = JaxSim(P, capacity=256, topology=topology, layout="packed")
    ps = packed(P, topology=topology, use_kernels=use_kernels)
    sims = (js, ps)
    for s in sims:
        writes(s, 1)
    assert js.step(1) == ps.step(1)
    assert js.stats["ops_applied"] == ps.stats["ops_applied"] > 0
    assert_same(js, ps)
    assert js.converged() is ps.converged() is False
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert ps._convergence_strategy()[0] == (
        "packed-frontier-local" if use_kernels else "packed-loop")
    assert js.converged() is ps.converged() is True
    assert ps.tables_equal() and js.tables_equal()
    assert_same(js, ps)

    for s in sims:  # past the initial capacity: the table grows
        writes(s, 2, n_bulk=400)
    assert js.run_until_converged(max_rounds=3) == ps.run_until_converged(max_rounds=3)
    assert js.last_residual == ps.last_residual > 0  # a cutoff's residual
    assert js.converged() is ps.converged() is False
    for s in sims:
        writes(s, 3)
        s.reconcile()
    assert ps.capacity == js.capacity > 256
    assert js.stats == {k: ps.stats.get(k, v) for k, v in js.stats.items()}
    assert_same(js, ps)
    assert js.converged() is ps.converged() is True
    names = paths_of(ps)
    assert names == paths_of(js)
    for peer in (0, 7, P - 1):
        assert ps.get(peer) == js.get(peer)
        for path in ("obj", "n", "mix/b", "nope"):
            assert ps.get(peer, path) == js.get(peer, path)
    rng = np.random.default_rng(3)
    peers = np.append(rng.integers(0, P, 50), 0)
    sample = [names[int(i)] for i in rng.integers(0, len(names), 50)] + ["missing/x"]
    assert ps.get_bulk(peers, sample) == js.get_bulk(peers, sample)
    slots = np.arange(len(names), dtype=np.int32)
    assert ps.get_bulk(5, slots) == js.get_bulk(5, slots)


@pytest.mark.parametrize("topology", ["ring", "chain", "mesh", "star", "bridge"])
def test_sim_packed_matches_dense(topology):
    def run(sim):
        rng = np.random.default_rng(8)
        for _ in range(60):
            sim.put(int(rng.integers(11)), f"g/k{int(rng.integers(8))}",
                    float(rng.integers(100)))
        sim.put(0, "g/name", "zeta")
        sim.put(5, "g/name", "alpha")
        rounds = sim.run_until_converged()
        assert sim.tables_equal()
        return rounds, sim.get(3, "g")

    js = JaxSim(11, capacity=64, topology=topology, layout="packed")
    ps = packed(11, 64, topology)
    dense = PeerNetworkSim(11, capacity=64, topology=topology, device="cpu")
    assert run(ps) == run(js)
    assert run(dense)[1] == run(PeerNetworkSim(11, capacity=64, topology=topology,
                                               layout="packed", device="cpu"))[1]
    assert_same(js, ps)


def test_sim_packed_capacity_growth():
    js = JaxSim(4, capacity=8, topology="ring", layout="packed")
    ps = packed(4, 8, use_kernels=True)
    for s in (js, ps):
        for i in range(40):
            s.put(i % 4, f"deep/k{i}", i)
        s.run_until_converged()
        assert s.capacity >= 40
        assert s.get(3, "deep/k39") == 39
    assert_same(js, ps)


def test_packed_rejects_lww():
    with pytest.raises(ValueError, match="reference mode"):
        PeerNetworkSim(4, layout="packed", mode="lww", device="cpu")


def test_sim_converged_probe():
    js = JaxSim(8, capacity=256, topology="ring", layout="packed")
    ps = packed(8, 256, use_kernels=True)
    for s in (js, ps):
        s.put(0, "c/x", 3)
        s.step(rounds=0)  # apply only
    before = packed_to_numpy(ps.table)
    assert js.converged() is ps.converged() is False
    for a, b in zip(before, packed_to_numpy(ps.table)):  # the probe wrote nothing
        np.testing.assert_array_equal(a, b)
    for s in (js, ps):
        s.run_until_converged()
        assert s.converged() and s.tables_equal()
    assert_same(js, ps)


def test_frontier_incremental_seed():
    """After a completed convergence the next run seeds the frontier from
    the stripes the new ops touched, and still reaches the state and round
    count of the reference's whole-table loop."""
    first = [(i % 16, f"a/k{i % 40}", i) for i in range(100)]
    second = [(3, "a/k7", 10_000), (9, "b/new", 42)]
    js = JaxSim(16, capacity=2048, topology="ring", layout="packed")
    ps = packed(16, 2048, use_kernels=True)
    for s in (js, ps):
        for peer, path, value in first:
            s.put(peer, path, value)
    assert js.run_until_converged() == ps.run_until_converged()
    assert ps._marks.columns() is not None and not ps._marks.columns().any()
    for s in (js, ps):
        for peer, path, value in second:
            s.put(peer, path, value)
    seeds, seed_of = [], ps._marks.seed
    ps._marks.seed = lambda device: seeds.append(seed_of(device)) or seeds[-1]
    assert js.run_until_converged() == ps.run_until_converged()
    # only the stripe the two ops touched (their slots share stripe 0)
    assert seeds[-1].tolist() == [True] + [False] * 7
    assert ps.tables_equal()
    assert_same(js, ps)
    assert ps.get(0, "a/k7") == 10_000
    assert ps.get(15, "b/new") == 42


def test_frontier_seed_invalidation_paths():
    """Manual step rounds, capacity growth and restore forget the
    clean-stripe knowledge (the next run starts all-dirty)."""
    ps = packed(16, 256, use_kernels=True)
    ps.put(0, "x/a", 1)
    ps.run_until_converged()
    assert ps._marks.columns() is not None
    ps.put(1, "x/a", 2)
    ps.step()  # untracked gossip
    assert ps._marks.columns() is None
    ps.run_until_converged()
    assert ps.tables_equal()
    snap = ps.snapshot()
    ps.restore(snap)
    assert ps._marks.columns() is None
    ps.run_until_converged()
    assert ps._marks.columns() is not None
    for i in range(300):  # past capacity
        ps.put(i % 16, f"grow/{i}", i)
    ps.step(0)
    assert ps._marks.columns() is None
    ps.run_until_converged()
    assert ps.tables_equal() and ps.get(5, "x/a") == 2 and ps.get(3, "grow/299") == 299


def test_restore_from_reference_packed_snapshot():
    """State carried across: a JAX packed snapshot restores into the port
    (the interners are not in a snapshot, so the port sim gets the same
    puts, which restore discards); reads and the converged table agree."""
    js = JaxSim(P, capacity=512, topology="ring", layout="packed")
    ps = packed(P, 512, use_kernels=True)
    for s in (js, ps):
        writes(s, 4)
    js.step(3)
    snap = js.snapshot()
    ps.restore(snap)
    assert not any(ps._pending) and not ps._pending_bulk
    assert_same(js, ps)
    names = paths_of(js)
    assert ps.get_bulk(np.arange(len(names)) % P, names) == js.get_bulk(
        np.arange(len(names)) % P, names)
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps)
    assert ps.get(5) == js.get(5)
    own = ps.snapshot()
    assert len(own["table"]) == 3
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(own["table"], js.table))


def test_packed_convert_roundtrip():
    rng = np.random.default_rng(0)
    fields = [rng.integers(-9, 9, (4, 32), dtype=np.int32) for _ in range(3)]
    t = packed_from_numpy(fields, "cpu")
    assert t._fields == ("khi", "klo", "cv")
    for a, b in zip(packed_to_numpy(t), fields):
        np.testing.assert_array_equal(a, b)
    t.khi[0, 0] += 1  # a copy, not a view
    assert fields[0][0, 0] != int(t.khi[0, 0])
    with pytest.raises(ValueError):
        packed_from_numpy(fields[:2], "cpu")
    with pytest.raises(ValueError):
        packed_from_numpy([f.astype(np.int64) for f in fields], "cpu")


def test_string_rebalance_rekeys_packed_table():
    sims = (JaxSim(2, capacity=64, topology="ring", layout="packed"), packed(2, 64))
    for s in sims:
        s.put(0, "w", "m")
        s.run_until_converged()
        word = "m"
        for i in range(64):  # adversarial inserts force rank rebalances
            word = word + ("a" if i % 2 else "z")
            s.put(0, f"w{i}", word)
        s.run_until_converged()
        s.put(0, "battle", "aaa")
        s.put(1, "battle", "zzz")
        s.run_until_converged()
        assert s.get(0, "battle") == "zzz"
    assert sims[0].host.values.epoch > 0
    assert_same(*sims)


@pytest.mark.parametrize("seed", [0, 1])
def test_reconcile_weak_topology_packed(seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((10, 10)) < 0.15
    np.fill_diagonal(adj, False)
    js = JaxSim(10, capacity=64, topology=jax_topo.from_adjacency(adj), layout="packed")
    ps = packed(10, 64, topo.from_adjacency(adj))
    twin = packed(10, 64, topo.from_adjacency(adj))
    assert not ps.topology.is_connected()
    for s in (js, ps, twin):
        for i in range(30):
            s.put(i % 10, f"d/k{i % 6}", int((i * 37 + seed) % 50))
    js.reconcile()
    ps.reconcile()
    assert_same(js, ps)
    twin.run_until_converged(max_rounds=30)
    assert twin.last_residual == 0
    for a, b in zip(ps.table, twin.table):
        assert torch.equal(a, b)


def test_on_callbacks_packed():
    seen = {"jax": [], "port": []}
    sims = {"jax": JaxSim(6, capacity=64, topology="chain", layout="packed"),
            "port": packed(6, 64, "chain", use_kernels=True)}
    for name, s in sims.items():
        log = seen[name]
        s.on(5, "w", lambda v, log=log: log.append(("w", v)))
        s.on(0, "", lambda v, log=log: log.append(("root", v)))
        s.put(0, "w/a", 5)
        s.run_until_converged()
        s.put(1, "w/a", 2)  # loses in reference mode -> no callback
        s.put(2, "w/b", "x")
        s.step(1)
        s.off(0, "")
        s.reconcile()
    assert seen["jax"] == seen["port"]
    assert seen["port"][-1] == ("w", {"a": 5, "b": "x"})


def test_packed_big_p_ring_steps():
    """P = 4096: single rounds and the count-only probe on the port's
    column-owning route, against the reference sim (XLA rounds on the
    CPU); convergence itself is left to the card (thousands of rounds)."""
    js = JaxSim(4096, capacity=128, topology="ring", layout="packed")
    ps = packed(4096, 128, use_kernels=True)
    rng = np.random.default_rng(2)
    peers = rng.integers(0, 4096, 600)
    leaves = [f"b/{i}" for i in rng.integers(0, 100, 600)]
    vals = rng.integers(-50, 50, 600)
    for s in (js, ps):
        s.put_bulk(peers, leaves, vals)
    assert js.step(2) == ps.step(2)
    assert js.stats["ops_applied"] == ps.stats["ops_applied"]
    assert js.converged() is ps.converged() is False
    assert_same(js, ps)
    assert table_to_numpy(ps.table)[0].shape == (4096, 128)
