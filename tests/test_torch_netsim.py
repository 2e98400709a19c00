"""The slice as a whole: the same puts go into a reference PeerNetworkSim
(JAX, CPU) and a port sim (device="cpu"); tables, residuals, round counts
and read values must be identical. Covers scalar, string, object and bulk
puts, step, run_until_converged (kernel and plain routes), cutoffs,
reconcile (strong and weak topologies), capacity growth, string rebalance
rekeying, JAX snapshot -> port restore, and on() callbacks."""

import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.parallel import topology as topo

torch.set_num_threads(2)

P = 16


def assert_same(jax_sim, port_sim):
    for a, b in zip(table_to_numpy(port_sim.table), jax_sim.table):
        np.testing.assert_array_equal(a, np.asarray(b))


def writes(sim, seed, n_scalar=40, n_bulk=200):
    """One deterministic write stream: numbers with ties, strings, nulls,
    bools, small and large objects, a remove, and bulk batches by path,
    by pre-interned slot id and with mixed values."""
    rng = np.random.default_rng(seed)
    for _ in range(n_scalar):
        peer = int(rng.integers(P))
        key = int(rng.integers(12))
        kind = int(rng.integers(4))
        if kind == 0:
            sim.put(peer, f"n/k{key}", int(rng.integers(-9, 9)))
        elif kind == 1:
            sim.put(peer, f"s/k{key}", "v" + "xyz"[int(rng.integers(3))] * key)
        elif kind == 2:
            sim.put(peer, f"b/k{key}", bool(rng.integers(2)) if key % 3 else None)
        else:
            sim.put(peer, f"f/k{key}", float(rng.integers(-4, 4)) / 2)
    sim.put(3, "obj/small", {"a": 1, "b": {"c": "x"}})
    sim.put(9, "obj/big", {f"f{i}": i * (seed % 5) for i in range(7)})
    sim.remove(5, "n/k1")
    peers = rng.integers(0, P, n_bulk)
    sim.put_bulk(peers, [f"bulk/{seed}/{int(i)}" for i in rng.integers(0, 150, n_bulk)],
                 rng.integers(-30, 30, n_bulk))
    slots = np.asarray([sim.intern_path(f"ids/{i}") for i in range(8)], np.int32)
    sim.put_bulk(rng.integers(0, P, 40), slots[rng.integers(0, 8, 40)],
                 rng.integers(0, 5, 40).astype(np.float64))
    sim.put_bulk(2, ["mix/a", "mix/b", "mix/c"], ["str", 4, None])


def paths_of(sim):
    return [sim.host.paths.path(i) for i in range(len(sim.host.paths))]


@pytest.mark.parametrize("topology,mode,use_kernels", [
    ("ring", "reference", True),
    ("ring", "lww", False),
    ("chain", "reference", False),
    ("chain", "lww", True),
])
def test_sim_matches_reference(topology, mode, use_kernels):
    js = JaxSim(P, capacity=256, topology=topology, mode=mode)
    ps = PeerNetworkSim(P, capacity=256, topology=topology, mode=mode,
                        device="cpu", use_kernels=use_kernels)
    sims = (js, ps)
    for s in sims:
        writes(s, 1)
    assert js.step(2) == ps.step(2)
    assert_same(js, ps)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert ps._convergence_strategy()[0] == (
        "dense-frontier" if use_kernels else "dense-loop")
    assert ps.tables_equal() and js.tables_equal()
    assert_same(js, ps)

    for s in sims:  # past the initial capacity: the table grows
        writes(s, 2, n_bulk=400)
    for s in sims:
        s.reconcile()
    assert ps.capacity == js.capacity > 256
    assert_same(js, ps)
    names = paths_of(ps)
    assert names == paths_of(js)
    for peer in (0, 7, P - 1):
        assert ps.get(peer) == js.get(peer)
        for path in ("obj", "n", "mix/b", "nope"):
            assert ps.get(peer, path) == js.get(peer, path)
    rng = np.random.default_rng(3)
    peers = rng.integers(0, P, 50)
    sample = [names[int(i)] for i in rng.integers(0, len(names), 50)] + ["missing/x"]
    peers = np.append(peers, 0)
    assert ps.get_bulk(peers, sample) == js.get_bulk(peers, sample)

    for s in sims:  # a cutoff leaves the residual of the last round run
        writes(s, 3)
    assert js.run_until_converged(max_rounds=3) == ps.run_until_converged(max_rounds=3)
    assert js.last_residual == ps.last_residual
    assert_same(js, ps)
    assert js.run_until_converged() == ps.run_until_converged()
    assert_same(js, ps)


def test_restore_from_reference_snapshot():
    """Weights carried across: a JAX snapshot restores into the port (the
    interners are not in a snapshot, so the port sim gets the same puts,
    which restore discards)."""
    js = JaxSim(P, capacity=512, topology="ring")
    ps = PeerNetworkSim(P, capacity=512, topology="ring", device="cpu",
                        use_kernels=True)
    for s in (js, ps):
        writes(s, 4)
    js.step(3)
    snap = js.snapshot()
    ps.restore(snap)
    assert not any(ps._pending) and not ps._pending_bulk
    assert_same(js, ps)
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps)
    assert ps.get(5) == js.get(5)
    own = ps.snapshot()
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(own["table"], js.table))


def test_string_rebalance_rekeys_table():
    sims = (JaxSim(2, capacity=64, topology="ring"),
            PeerNetworkSim(2, capacity=64, topology="ring", device="cpu"))
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
    assert_same(*sims)


def test_on_callbacks_match():
    seen = {"jax": [], "port": []}
    sims = {"jax": JaxSim(6, capacity=64, topology="chain"),
            "port": PeerNetworkSim(6, capacity=64, topology="chain", device="cpu",
                                   use_kernels=True)}
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


@pytest.mark.parametrize("seed", [0, 1])
def test_reconcile_weak_topology_matches(seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((10, 10)) < 0.15
    np.fill_diagonal(adj, False)
    js = JaxSim(10, capacity=64, topology=jax_topo.from_adjacency(adj))
    ps = PeerNetworkSim(10, capacity=64, topology=topo.from_adjacency(adj), device="cpu")
    twin = PeerNetworkSim(10, capacity=64, topology=topo.from_adjacency(adj), device="cpu")
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


def test_converged_does_not_advance_and_peer_cursor():
    ps = PeerNetworkSim(4, capacity=32, topology="ring", device="cpu", use_kernels=True)
    ps.peer(2).get("a").get("b").put(7)
    ps.step(0)
    before = table_to_numpy(ps.table)
    assert not ps.converged()
    for a, b in zip(before, table_to_numpy(ps.table)):
        np.testing.assert_array_equal(a, b)
    ps.run_until_converged()
    assert ps.converged()
    assert ps.peer(0).get("a").value() == {"b": 7}
    assert ps.peer(3).value() == {"a": {"b": 7}}


@pytest.mark.parametrize("kwargs", [
    {"layout": "rank", "mesh_devices": 2},
    {"layout": "rank1", "use_shard_map": True, "mesh_devices": 2},
    {"layout": "packed", "mesh_devices": 2},
    {"layout": "packed", "use_shard_map": True, "mesh_devices": 4},
    {"layout": "rank1", "mesh_devices": ["cpu", "cpu"]},
])
def test_unported_options_raise(kwargs):
    """The option sets that raised while the packed family on a mesh was
    unported now build a sharded sim of the layout, which converges (its
    parity with the reference: tests/test_torch_shard_packed_sim.py)."""
    from bullet_tpu_torch.parallel.mesh import ShardedTable

    sim = PeerNetworkSim(8, device="cpu", **kwargs)
    shards = kwargs["mesh_devices"]
    assert isinstance(sim.table, ShardedTable)
    assert len(sim.table.shards) == (shards if isinstance(shards, int) else len(shards))
    assert type(sim.table.shards[0]).__name__ == {
        "packed": "PackedTable", "rank": "RankTable", "rank1": "Rank1Table"}[kwargs["layout"]]
    sim.put(1, "a/b", 7)
    sim.run_until_converged()
    assert sim.tables_equal() and sim.get(6, "a/b") == 7


def test_plain_routes_refused_on_cuda():
    """Only a CPU sim may turn the kernel routes off; the check comes before
    any device allocation."""
    with pytest.raises(ValueError, match="use_kernels=False"):
        PeerNetworkSim(8, device="cuda", use_kernels=False)
