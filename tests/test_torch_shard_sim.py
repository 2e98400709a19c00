"""Sharded port sims against the reference's sharded sims on its 8-device
CPU mesh (the counterpart of tests/test_sharding.py and the sim tests of
tests/test_shardmap_gossip.py): data meshes and shard_map meshes, full
and lean, every topology; the dense part of the multi-chip dry run
(__graft_entry__.dryrun_multichip); partition and heal; the route table
with dense-frontier-spmd; snapshots carried across the packages. The port
runs ``device="cpu"`` with virtual shards. Tolerance: exact (every field,
residuals, round counts and reads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bullet_tpu.parallel.mesh import shard_table as jax_shard_table
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.ops.merge import TableState
from bullet_tpu_torch.parallel import topology as topo
from bullet_tpu_torch.parallel.mesh import ShardedTable
from bullet_tpu_torch.parallel.shardmap_gossip import HALO_FUSE, gossip_frontier_shardmap_dense

torch.set_num_threads(2)

needs_devices = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
pytestmark = needs_devices


def assert_same(jax_sim, port_sim, fields=7):
    for a, b in list(zip(table_to_numpy(port_sim.table), jax_sim.table))[:fields]:
        np.testing.assert_array_equal(a, np.asarray(b))


def writes(sim, seed, p, puts=50, paths=8):
    rng = np.random.default_rng(seed)
    for _ in range(puts):
        sim.put(int(rng.integers(p)), f"k/v{int(rng.integers(paths))}", int(rng.integers(1000)))
    sim.put(0, "s/name", "alice")
    sim.put(p - 1, "s/name", "bob")
    sim.put(p // 2, "obj", {"a": 1, "b": {"c": "x"}})


def pair(p, capacity, topology, port_topology=None, **kw):
    """A reference sim and a port sim of the same options (``use_pallas``
    on the reference is ``use_kernels`` on the port)."""
    port_kw = dict(kw)
    if "use_pallas" in port_kw:
        port_kw["use_kernels"] = port_kw.pop("use_pallas")
    js = JaxSim(p, capacity=capacity, topology=topology, **kw)
    ps = PeerNetworkSim(p, capacity=capacity, topology=port_topology or topology, device="cpu",
                        **port_kw)
    return js, ps


# ------------------------------------------------------------ data mesh


@pytest.mark.parametrize("topology", ["ring", "chain", "mesh", "star", "bridge"])
def test_data_mesh_sim_matches_reference(topology):
    """A data mesh (no shard_map) gives the unsharded bits: its own step
    and loop rounds, never the frontier."""
    js, ps = pair(16, 64, topology, mesh_devices=8)
    assert isinstance(ps.table, ShardedTable) and len(ps.table.shards) == 8
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == "dense-loop"
    for s in (js, ps):
        writes(s, 5, 16)
    assert js.step(1) == ps.step(1)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert ps.tables_equal()
    assert_same(js, ps)
    assert ps.get(3) == js.get(3)


@pytest.mark.parametrize("lean,mode", [(False, "reference"), (True, "reference"), (False, "lww")])
def test_sharded_equals_unsharded_and_reconciles(lean, mode):
    """test_sharding.py's sharded-vs-unsharded and sharded reconcile, with
    lean gossip on the kernel route (the lean round on a data mesh)."""
    sims = [PeerNetworkSim(16, capacity=128, topology="ring", mode=mode, lean_gossip=lean,
                           device="cpu", use_kernels=True, mesh_devices=k) for k in (None, 8)]
    js = JaxSim(16, capacity=128, topology="ring", mode=mode, lean_gossip=lean, use_pallas=True,
                mesh_devices=8)
    for s in (*sims, js):
        writes(s, 9, 16, puts=80)
    for s in (*sims, js):
        s.step(2)
    assert_same(js, sims[1])
    for s in (*sims, js):
        s.run_until_converged()
        writes(s, 12, 16)
        s.reconcile()
        assert s.tables_equal()
    for a, b in zip(table_to_numpy(sims[0].table), table_to_numpy(sims[1].table)):
        np.testing.assert_array_equal(a, b)
    assert_same(js, sims[1])


def test_padding_and_capacity_growth_on_a_mesh():
    """10 peers on 4 shards pad to 12; the table grows per shard."""
    js, ps = pair(10, 16, "ring", mesh_devices=4, use_shard_map=True)
    assert ps.num_peers == js.num_peers == 12 and ps.table.rows == 3
    for s in (js, ps):
        writes(s, 3, 10, puts=60, paths=40)
        s.run_until_converged()
    assert ps.capacity == js.capacity > 16
    assert_same(js, ps)
    assert ps.get_bulk([0, 11], ["k/v3", "s/name"]) == js.get_bulk([0, 11], ["k/v3", "s/name"])


# ------------------------------------------------------- shard_map sims


@pytest.mark.parametrize("topology", ["ring", "chain", "mesh", "star", "bridge"])
def test_shard_map_sim_all_topologies(topology):
    """Explicit exchange rounds for every topology family, step by step
    and to the fixed point (too few rows per shard for the frontier)."""
    js, ps = pair(16, 64, topology, mesh_devices=8, use_shard_map=True, use_pallas=True)
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == "dense-loop"
    for s in (js, ps):
        writes(s, 17, 16)
    assert js.step(1) == ps.step(1)
    assert_same(js, ps)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.converged() == ps.converged()
    assert_same(js, ps)


@pytest.mark.parametrize("mode,lean,topology", [
    ("lww", False, "ring"), ("reference", False, "chain"), ("reference", True, "ring"),
    ("reference", True, "chain"),
])
def test_dense_frontier_spmd_sim_matches_reference(mode, lean, topology):
    """8 rows per shard: the dense-frontier-spmd route, lean or full, with
    step (the full-metadata exchange), a converge, a cutoff, converged(),
    reconcile and reads, against the reference's sharded sim."""
    js, ps = pair(64, 256, topology, mode=mode, lean_gossip=lean, mesh_devices=8,
                  use_shard_map=True, use_pallas=True)
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == "dense-frontier-spmd"
    for s in (js, ps):
        writes(s, 41, 64, puts=120, paths=30)
    assert js.step(1) == ps.step(1)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert_same(js, ps)
    assert js.converged() == ps.converged()
    for s in (js, ps):
        writes(s, 42, 64, puts=60, paths=300)  # grows the table
    assert js.run_until_converged(max_rounds=9) == ps.run_until_converged(max_rounds=9)
    assert js.last_residual == ps.last_residual
    assert_same(js, ps)
    for s in (js, ps):
        s.reconcile()
    assert_same(js, ps)
    for peer in (0, 33, 63):
        assert ps.get(peer) == js.get(peer)


def test_sim_dense_frontier_spmd_matches_unsharded():
    """test_shardmap_gossip.py's sim-level check: the sharded frontier sim
    (lww: clocks sync too) against an unsharded sim, then more writes."""
    def build(**kw):
        sim = PeerNetworkSim(32, capacity=1024, topology="ring", mode="lww", device="cpu", **kw)
        rng = np.random.default_rng(41)
        for _ in range(60):
            sim.put(int(rng.integers(32)), f"k/v{int(rng.integers(8))}", int(rng.integers(1000)))
        return sim

    plain = build(use_kernels=False)
    sharded = build(mesh_devices=4, use_shard_map=True, use_kernels=True)
    assert sharded._convergence_strategy()[0] == "dense-frontier-spmd"
    assert plain.run_until_converged() == sharded.run_until_converged()
    assert sharded.tables_equal()
    for a, b in zip(table_to_numpy(plain.table), table_to_numpy(sharded.table)):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(plain._clock_snapshot(), sharded._clock_snapshot())


@pytest.mark.parametrize("kw,ref_route", [
    (dict(mesh_devices=8, use_shard_map=True, use_pallas=True), "dense-frontier-spmd"),
    (dict(mesh_devices=8, use_shard_map=True, use_pallas=True, lean_gossip=True),
     "dense-frontier-spmd"),
    (dict(mesh_devices=8, use_shard_map=True, use_pallas=False), "dense-loop"),
    (dict(mesh_devices=8, use_pallas=True), "dense-loop"),
    (dict(mesh_devices=4, use_shard_map=True, use_pallas=True), "dense-frontier-spmd"),
    (dict(mesh_devices=8, use_shard_map=True, use_pallas=True, capacity=96), "dense-loop"),
    (dict(use_shard_map=True, use_pallas=True), "dense-frontier"),
    (dict(use_shard_map=True, use_pallas=True, lean_gossip=True, capacity=96), "dense-loop"),
])
def test_route_table_matches_reference(kw, ref_route):
    """The convergence route of each cell (spmd, data mesh, rows per
    shard, n % 128, lean) is the reference's."""
    kw = dict(kw)
    capacity = kw.pop("capacity", 128)
    for p in (64, 32):  # 8 rows per shard on 8 devices, then 4 (< 8)
        js, ps = pair(p, capacity, "ring", **kw)
        assert ps._convergence_strategy()[0] == js._convergence_strategy()[0]
        if p == 64:
            assert ps._convergence_strategy()[0] == ref_route
        assert (ps._frontier_tile() > 0) == (js._frontier_tile() > 0)


# -------------------------------------------- the multi-chip dry run, dense


def test_dryrun_multichip_dense_mirrored():
    """The dense steps of __graft_entry__.dryrun_multichip(8) on the port."""
    n_dev = 8
    num_peers = 2 * n_dev
    sim = PeerNetworkSim(num_peers, capacity=128, topology="ring", mode="reference",
                         mesh_devices=n_dev, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(4 * num_peers):
        sim.put(int(rng.integers(num_peers)), f"users/u{int(rng.integers(8))}/score",
                float(rng.integers(100)))
    sim.put(0, "users/u0/name", "alice")
    assert sim.run_until_converged() >= 1 and sim.tables_equal()
    assert len(sim.table.shards) == n_dev
    assert sim.get(num_peers - 1, "users/u0/name") == "alice"

    sim2 = PeerNetworkSim(num_peers, capacity=64, topology="chain", mesh_devices=n_dev,
                          device="cpu")
    sim2.put(0, "far/value", 7)
    sim2.run_until_converged()
    assert sim2.get(num_peers - 1, "far/value") == 7

    # the dense spmd frontier (lww, full metadata): fused and single-round
    # loops agree on state and round count
    sim5 = PeerNetworkSim(8 * n_dev, capacity=128, topology="ring", mode="lww",
                          mesh_devices=n_dev, use_shard_map=True, use_kernels=True, device="cpu")
    assert sim5._convergence_strategy()[0] == "dense-frontier-spmd"
    for p in range(8 * n_dev):
        sim5.put(p, f"d/p{p}", p + 1)
    sim5.run_until_converged()
    assert sim5.tables_equal()
    t_total = sim5.table.shape[1] // sim5._frontier_tile()
    fields = table_to_numpy(sim5.table)
    results = []
    for fuse in (HALO_FUSE, 1):
        table = sim5.table.map(lambda s: TableState(*(f.clone() for f in s)))
        got, r, _ = gossip_frontier_shardmap_dense(
            table, torch.ones(t_total, dtype=torch.bool), True, "lww", False, 4 * n_dev,
            fuse=fuse)
        results.append((r, table_to_numpy(got)))
    assert results[0][0] == results[1][0]
    for a, b, f in zip(results[0][1], results[1][1], fields):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, f)  # a converged table stays put


def test_partition_and_heal():
    """A dropped bridge peer blocks cross-cluster convergence under the
    generic exchange; healing converges (test_shardmap_gossip.py)."""
    t = topo.bridge((4, 3), 1)
    sim = PeerNetworkSim(t.num_peers, capacity=64, topology=t, mesh_devices=8,
                         use_shard_map=True, device="cpu")
    js = JaxSim(t.num_peers, capacity=64, topology=jax_topo.bridge((4, 3), 1), mesh_devices=8,
                use_shard_map=True)
    bridge_peer = t.num_peers - 1
    sim.topology = t.drop_peer(bridge_peer)
    js.topology = js.topology.drop_peer(bridge_peer)
    for s in (sim, js):
        s.put(0, "left", 1)
        s.put(4, "right", 2)
        s.run_until_converged(max_rounds=10)
    assert sim.get(4, "left") is None and sim.get(0, "right") is None
    assert_same(js, sim)
    sim.topology = t
    js.topology = jax_topo.bridge((4, 3), 1)
    assert sim.run_until_converged() == js.run_until_converged()
    assert sim.tables_equal()
    assert sim.get(4, "left") == 1 and sim.get(0, "right") == 2
    assert_same(js, sim)


@pytest.mark.parametrize("lean", [False, True])
def test_weak_reconcile_on_a_mesh(lean):
    """Per-SCC closure joins gather the few rows from their shards and
    write each member's shard."""
    rng = np.random.default_rng(7)
    adj = rng.random((16, 16)) < 0.1
    np.fill_diagonal(adj, False)
    js, ps = pair(16, 64, jax_topo.from_adjacency(adj), topo.from_adjacency(adj),
                  mesh_devices=8, lean_gossip=lean)
    assert not ps.topology.is_connected()
    for s in (js, ps):
        writes(s, 8, 16)
        s.reconcile()
    assert_same(js, ps)


# ------------------------------------------------- snapshots both ways


def test_snapshots_cross_packages_on_meshes():
    """A reference sharded sim's snapshot restores into a sharded port sim
    and back; the port's snapshot is the whole table on the host."""
    js, ps = pair(64, 256, "ring", mesh_devices=8, use_shard_map=True, use_pallas=True,
                  mode="lww")
    for s in (js, ps):
        writes(s, 21, 64)
    js.step(3)
    ps.restore(js.snapshot())
    assert_same(js, ps)
    assert isinstance(ps.table, ShardedTable)
    assert js.run_until_converged() == ps.run_until_converged()
    assert_same(js, ps)
    for s in (js, ps):
        writes(s, 22, 64)
    ps.step(2)
    back = JaxSim(64, capacity=256, topology="ring", mesh_devices=8, use_shard_map=True,
                  use_pallas=True, mode="lww")
    writes(back, 21, 64)
    writes(back, 22, 64)
    back.restore(ps.snapshot())
    assert_same(back, ps)
    assert len(back.table.cls.devices()) == 8
    assert back.get(5) == ps.get(5)
    whole = jax_shard_table(JaxTable(*(jnp.asarray(f) for f in table_to_numpy(ps.table))),
                            jax_make_mesh(8))
    for a, b in zip(table_to_numpy(ps.table), whole):
        np.testing.assert_array_equal(a, np.asarray(b))
