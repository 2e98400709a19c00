"""Sharded packed-family port sims against the reference's sharded sims on
its 8-device CPU mesh (the counterpart of the packed parts of
tests/test_shardmap_gossip.py, tests/test_sharding.py and
__graft_entry__.dryrun_multichip): packed, rank and rank1 on shard_map
meshes (packed-frontier-spmd) and data meshes, ring and chain; mesh, star
and bridge on packed-loop; converged(), reconcile on strong and weak
topologies, fast_forward == step on the spmd window route, reads,
snapshots across the packages and across mesh and no mesh, capacity
growth, a rank respread on a mesh; the route table and the whole
CONVERGENCE_STRATEGIES cell matrix. The port runs ``device="cpu"`` with
virtual shards. Tolerance: exact (every field, residuals, round counts
and reads)."""

import itertools

import jax
import numpy as np
import pytest
import torch

from bullet_tpu.models import netsim as jax_netsim
from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops import rank as jrk
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.models import netsim as port_netsim
from bullet_tpu_torch.ops import rank as rk
from bullet_tpu_torch.parallel import topology as topo
from bullet_tpu_torch.parallel.mesh import ShardedTable
from bullet_tpu_torch.parallel.shardmap_gossip import HALO_FUSE, gossip_frontier_shardmap_packed

torch.set_num_threads(2)

needs_devices = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
pytestmark = needs_devices
LAYOUTS = ("packed", "rank", "rank1")
SPMD = dict(mesh_devices=8, use_shard_map=True, use_pallas=True)


def assert_same(jax_sim, port_sim):
    got, want = table_to_numpy(port_sim.table), jax_sim.table
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def writes(sim, seed, p, puts=50, paths=8):
    rng = np.random.default_rng(seed)
    for _ in range(puts):
        sim.put(int(rng.integers(p)), f"k/v{int(rng.integers(paths))}", int(rng.integers(1000)))
    sim.put(0, "s/name", "alice")
    sim.put(p - 1, "s/name", "bob")
    sim.put(p // 2, "obj", {"a": 1, "b": {"c": "x"}})


def pair(p, capacity, topology, layout, port_topology=None, **kw):
    """A reference sim and a port sim of the same options (``use_pallas``
    on the reference is ``use_kernels`` on the port)."""
    port_kw = dict(kw)
    if "use_pallas" in port_kw:
        port_kw["use_kernels"] = port_kw.pop("use_pallas")
    js = JaxSim(p, capacity=capacity, topology=topology, layout=layout, **kw)
    ps = PeerNetworkSim(p, capacity=capacity, topology=port_topology or topology, layout=layout,
                        device="cpu", **port_kw)
    return js, ps


def reads_agree(js, ps, peers):
    for peer in peers:
        assert ps.get(peer) == js.get(peer)
    names = ["k/v1", "s/name", "obj/b/c", "nope"]
    assert ps.get_bulk(list(peers)[:1] * 4, names) == js.get_bulk(list(peers)[:1] * 4, names)


# ---------------------------------------------------------- spmd frontier


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_packed_frontier_spmd_sim_matches_reference(layout, topology):
    """8 rows per shard: packed-frontier-spmd with step (the exchange round
    on the per-shard kernel), a converge, converged(), a cutoff after the
    table grows, reconcile and reads, against the reference's sharded
    sim."""
    js, ps = pair(64, 256, topology, layout, **SPMD)
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == "packed-frontier-spmd"
    assert isinstance(ps.table, ShardedTable) and len(ps.table.shards) == 8
    for s in (js, ps):
        writes(s, 41, 64, puts=120, paths=30)
    assert js.step(1) == ps.step(1)
    assert_same(js, ps)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert ps.tables_equal()
    assert_same(js, ps)
    assert js.converged() == ps.converged() is True
    for s in (js, ps):
        writes(s, 42, 64, puts=300, paths=600)  # grows the table
    assert js.run_until_converged(max_rounds=9) == ps.run_until_converged(max_rounds=9)
    assert js.last_residual == ps.last_residual != 0
    assert js.converged() == ps.converged() is False
    assert_same(js, ps)
    assert ps.capacity == js.capacity > 256
    for s in (js, ps):
        s.reconcile()
    assert_same(js, ps)
    assert ps.tables_equal() and ps.converged()
    reads_agree(js, ps, (0, 33, 63))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_data_mesh_packed_sim_matches_reference(layout, topology):
    """A data mesh: packed-loop rounds with the unsharded bits, the spmd
    window fast_forward (the reference's whole-table window there)."""
    js, ps = pair(32, 128, topology, layout, mesh_devices=8, use_pallas=True)
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == "packed-loop"
    assert ps._fast_forward_route() == "spmd"
    for s in (js, ps):
        writes(s, 5, 32)
    assert js.step(1) == ps.step(1)
    assert js.fast_forward(3) == ps.fast_forward(3)
    assert_same(js, ps)
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert_same(js, ps)
    for key in ("gossip_rounds", "windowed_rounds", "ops_applied"):
        assert js.stats[key] == ps.stats[key], key
    reads_agree(js, ps, (3, 31))


@pytest.mark.parametrize("topology", ["mesh", "star", "bridge"])
@pytest.mark.parametrize("spmd", [True, False])
def test_packed_loop_topologies_on_a_mesh(topology, spmd):
    """packed-loop on the other topologies: a shard_map mesh's star is the
    hub reduce (its step the generic round, as the reference's), a data
    mesh's the generic round; rounds, residuals and state."""
    kw = SPMD if spmd else dict(mesh_devices=8, use_pallas=True)
    js, ps = pair(16, 64, topology, "packed", **kw)
    assert ps._convergence_strategy()[0] == js._convergence_strategy()[0] == "packed-loop"
    for s in (js, ps):
        writes(s, 17, 16)
    assert js.step(1) == ps.step(1)
    assert_same(js, ps)
    assert js.run_until_converged(max_rounds=1) == ps.run_until_converged(max_rounds=1)
    assert js.last_residual == ps.last_residual
    assert js.run_until_converged() == ps.run_until_converged()
    assert js.last_residual == ps.last_residual == 0
    assert js.converged() == ps.converged()
    assert_same(js, ps)
    reads_agree(js, ps, (0, 15))


# -------------------------------------------------------- fast_forward


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_fast_forward_spmd_matches_reference_and_step(layout, topology):
    """The spmd window route: passes of at most the 8 rows of a shard, the
    reference's state and residual, and step(k) on a port twin; a long jump
    lands on the fixed point and skips the rest."""
    js, ps = pair(64, 128, topology, layout, **SPMD)
    twin = PeerNetworkSim(64, capacity=128, topology=topology, layout=layout, device="cpu",
                          mesh_devices=8, use_shard_map=True, use_kernels=True)
    for s in (js, ps, twin):
        writes(s, 23, 64, puts=90)
    assert ps._fast_forward_route() == js._fast_forward_route() == "spmd"
    for k in (1, 5, 20):
        r = ps.fast_forward(k)
        assert r == js.fast_forward(k) == twin.step(k)
        assert_same(js, ps)
        for a, b in zip(table_to_numpy(ps.table), table_to_numpy(twin.table)):
            np.testing.assert_array_equal(a, b)
    assert ps.fast_forward(200) == js.fast_forward(200) == 0
    assert_same(js, ps)
    assert ps.stats["windowed_rounds"] == js.stats["windowed_rounds"] == 226
    assert ps._marks.columns() is not None


# -------------------------------------------------- reconcile, snapshots


@pytest.mark.parametrize("layout", LAYOUTS)
def test_weak_reconcile_on_a_mesh(layout):
    """Per-SCC closure joins gather the few rows from their shards."""
    rng = np.random.default_rng(7)
    adj = rng.random((16, 16)) < 0.1
    np.fill_diagonal(adj, False)
    js, ps = pair(16, 64, jax_topo.from_adjacency(adj), layout, topo.from_adjacency(adj),
                  mesh_devices=8)
    assert not ps.topology.is_connected()
    for s in (js, ps):
        writes(s, 8, 16)
        s.reconcile()
    assert_same(js, ps)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_snapshots_cross_packages_and_meshes(layout):
    """A reference sharded sim's snapshot restores into a sharded port sim;
    the port's sharded snapshot into an unsharded port sim and back into a
    reference sharded sim; all converge alike."""
    js, ps = pair(64, 256, "ring", layout, **SPMD)
    flat = PeerNetworkSim(64, capacity=256, topology="ring", layout=layout, device="cpu",
                          use_kernels=True)
    for s in (js, ps, flat):
        writes(s, 21, 64)
    js.step(3)
    ps.restore(js.snapshot())
    assert isinstance(ps.table, ShardedTable)
    assert_same(js, ps)
    assert js.run_until_converged() == ps.run_until_converged()
    assert_same(js, ps)
    for s in (js, ps, flat):
        writes(s, 22, 64)
    ps.step(2)
    flat.restore(ps.snapshot())
    assert not isinstance(flat.table, ShardedTable)
    if layout == "packed":  # a rank index's gaps depend on its insert batches
        for a, b in zip(table_to_numpy(flat.table), table_to_numpy(ps.table)):
            np.testing.assert_array_equal(a, b)
    assert [flat.get(q) for q in range(0, 64, 9)] == [ps.get(q) for q in range(0, 64, 9)]
    back = JaxSim(64, capacity=256, topology="ring", layout=layout, **SPMD)
    for seed in (21, 22):  # the port sim's rank index history: ranks match
        writes(back, seed, 64)
        back.step(0)
    back.restore(ps.snapshot())
    assert_same(back, ps)
    assert back.get(5) == ps.get(5) == flat.get(5)
    assert flat.run_until_converged() == ps.run_until_converged()


def test_padding_and_capacity_growth_on_a_mesh():
    """10 peers on 4 shards pad to 12; the rank1 table grows per shard."""
    js, ps = pair(10, 16, "ring", "rank1", mesh_devices=4, use_shard_map=True)
    assert ps.num_peers == js.num_peers == 12 and ps.table.rows == 3
    for s in (js, ps):
        writes(s, 3, 10, puts=60, paths=40)
        s.run_until_converged()
    assert ps.capacity == js.capacity > 16
    assert_same(js, ps)
    assert ps.get_bulk([0, 11], ["k/v3", "s/name"]) == js.get_bulk([0, 11], ["k/v3", "s/name"])


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_rank_respread_on_a_mesh(monkeypatch, layout):
    """Fresh floats exhaust a gap until the rank space respreads; every
    shard re-keys (rank through cv, rank1 through the pre-respread
    inverse), and the sharded sims stay the reference's, table for
    table."""
    monkeypatch.setattr(rk, "RANK_SPAN", 2047)
    monkeypatch.setattr(jrk, "RANK_SPAN", 2047)
    js, ps = pair(64, 64, "ring", layout, **SPMD)
    for s in (js, ps):
        writes(s, 13, 64, puts=40)
        s.run_until_converged()
    epoch0 = ps.rank_index.epoch
    rng = np.random.default_rng(14)
    while ps.rank_index.epoch == epoch0:
        for _ in range(40):
            peer, key, val = int(rng.integers(64)), int(rng.integers(9)), float(rng.random())
            for s in (js, ps):
                s.put(peer, f"m/k{key}", val)
        for s in (js, ps):
            s.run_until_converged()
        assert_same(js, ps)
        assert ps.rank_index.epoch < epoch0 + 50, "respread never fired"
    assert js.rank_index.epoch == ps.rank_index.epoch
    reads_agree(js, ps, (0, 40))


# ----------------------------------------------------------- route table


@pytest.mark.parametrize("kw,ref_route", [
    (SPMD, "packed-frontier-spmd"),
    (dict(mesh_devices=8, use_shard_map=True, use_pallas=False), "packed-loop"),
    (dict(mesh_devices=8, use_pallas=True), "packed-loop"),
    (dict(mesh_devices=4, use_shard_map=True, use_pallas=True), "packed-frontier-spmd"),
    (dict(SPMD, capacity=96), "packed-loop"),
    (dict(use_shard_map=True, use_pallas=True), "packed-frontier-local"),
])
def test_route_table_matches_reference(kw, ref_route):
    """The convergence route of each cell (spmd, data mesh, rows per shard,
    n % 128) is the reference's, for every layout of the family."""
    kw = dict(kw)
    capacity = kw.pop("capacity", 128)
    for layout in LAYOUTS:
        for p in (64, 32):  # 8 rows per shard on 8 devices, then 4 (< 8)
            js, ps = pair(p, capacity, "ring", layout, **kw)
            assert ps._convergence_strategy()[0] == js._convergence_strategy()[0]
            if p == 64:
                assert ps._convergence_strategy()[0] == ref_route
            assert (ps._frontier_tile() > 0) == (js._frontier_tile() > 0)


def _pick(table, cell):
    return next(name for name, pred, _ in table if pred(cell))


def test_strategy_cell_matrix_matches_reference():
    """Every cell of the strategy table resolves to the reference's row
    (``kernels`` is the reference's ``pallas``)."""
    for layout, *flags in itertools.product(("dense", *LAYOUTS), *[(False, True)] * 5):
        ref = jax_netsim.ConvergenceCell(layout, *flags)
        port = port_netsim.ConvergenceCell(layout, *flags)
        assert _pick(port_netsim.CONVERGENCE_STRATEGIES, port) == _pick(
            jax_netsim.CONVERGENCE_STRATEGIES, ref), port
    assert [r[0] for r in port_netsim.CONVERGENCE_STRATEGIES] == [
        r[0] for r in jax_netsim.CONVERGENCE_STRATEGIES]


# ------------------------------------ the multi-chip dry run, packed family


def test_dryrun_multichip_packed_mirrored():
    """The packed-family steps of __graft_entry__.dryrun_multichip(8) on the
    port: sharded converges of every layout to one state; the fused and
    window frontiers (m = 5, and the card's m = 63 at 64 rows per shard)
    against the single-round loop, state, rounds and residual; the spmd
    window fast_forward onto the converged state."""
    n_dev = 8
    sims = {}
    for layout in LAYOUTS:
        sim = PeerNetworkSim(8 * n_dev, capacity=128, topology="ring", layout=layout,
                             mesh_devices=n_dev, use_shard_map=True, use_kernels=True, device="cpu")
        assert sim._convergence_strategy()[0] == "packed-frontier-spmd"
        for p in range(8 * n_dev):
            sim.put(p, f"f/p{p}", p + 1)
        sim.run_until_converged()
        assert sim.tables_equal() and not sim._marks.columns().any()
        assert sim.get(0, f"f/p{8 * n_dev - 1}") == 8 * n_dev
        sims[layout] = sim
    np.testing.assert_array_equal(table_to_numpy(sims["rank"].table)[1],
                                  table_to_numpy(sims["packed"].table)[2])
    np.testing.assert_array_equal(table_to_numpy(sims["rank1"].table)[0],
                                  table_to_numpy(sims["rank"].table)[0])
    jump = PeerNetworkSim(8 * n_dev, capacity=128, topology="ring", layout="rank1",
                          mesh_devices=n_dev, use_shard_map=True, device="cpu")
    for p in range(8 * n_dev):
        jump.put(p, f"f/p{p}", p + 1)
    assert jump.fast_forward(4 * n_dev + 1) == 0
    assert jump.stats["windowed_rounds"] == 4 * n_dev + 1
    np.testing.assert_array_equal(table_to_numpy(jump.table)[0],
                                  table_to_numpy(sims["rank1"].table)[0])

    # converging at 8 rows per shard; at 64, cut off after 100 rounds
    for p_dev, window, max_rounds in ((8, 5, 64), (64, 63, 100)):
        p = p_dev * n_dev
        sim = PeerNetworkSim(p, capacity=128, topology="ring", layout="packed",
                             mesh_devices=n_dev, use_shard_map=True, use_kernels=True, device="cpu")
        sim.put_bulk(np.arange(p), [f"w/p{q}" for q in range(p)], np.arange(1, p + 1))
        sim.step(0)
        t_total = sim.table.shape[1] // sim._frontier_tile()
        results = []
        for mode in (dict(), dict(fuse=HALO_FUSE), dict(window_fuse=window)):
            table = sim.table.map(lambda s: type(s)(*(f.clone() for f in s)))
            got, r, c = gossip_frontier_shardmap_packed(
                table, torch.ones(t_total, dtype=torch.bool), True, max_rounds, **mode)
            results.append((r, c, table_to_numpy(got)))
        assert results[0][0] > 0
        for r, c, fields in results[1:]:
            assert (r, c) == results[0][:2]
            for a, b in zip(fields, results[0][2]):
                np.testing.assert_array_equal(a, b)
