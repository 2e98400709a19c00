"""The graph pass (``ops/packed.py`` ``gossip_graph_packed`` /
``converge_graph_packed``; on the card ``csrc/converge_graph.cu``) against
the reference's round loop on topologies other than a ring, a chain or a
full mesh.

Sims of the three packed-family layouts (packed, rank, rank1) with the
card's routes forced on the CPU (``PeerNetworkSim._card_routes`` patched),
so that their converges and ``step`` take the pass's plain version, are
held op by op against the JAX package's sims on bridge((5,) * 6, 2),
bridge((5, 5), 1), a star, a random graph and a directed graph that is not
symmetric: put_bulk then step(0), uncapped converges, converges capped at
1, 2 and 3 rounds and at 0, step(1..3), a converge of a settled table (one
round) and a converge after restore (the dirty-column tracking stale, every
column passed). After every op the tables, the return value,
``last_residual`` and ``stats`` must be equal. The plain version and the
plan are also held against the whole-table loop directly, with holes in
the neighbour matrix and every cap; ``perfbench/reference/graph_rounds.py``
against the same sims; the topology spec against ``topology.bridge``.
Tolerance: exact (all int32)."""

import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.parallel import topology as jtopo
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.ops.rank import Rank1Table, RankTable
from bullet_tpu_torch.parallel import topology as topo
from perfbench.reference import graph_rounds

torch.set_num_threads(2)

LAYOUTS = ("packed", "rank", "rank1")


def digraph(p: int, seed: int) -> np.ndarray:
    """A directed adjacency: a cycle (strongly connected) plus random
    one-way links."""
    rng = np.random.default_rng(seed)
    adj = rng.random((p, p)) < 0.1
    adj[np.arange(p), (np.arange(p) + 1) % p] = True
    np.fill_diagonal(adj, False)
    return adj


TOPOLOGIES = {
    "bridge6x5+2": lambda m: m.bridge((5,) * 6, 2),
    "bridge2x5+1": lambda m: m.bridge((5, 5), 1),
    "star13": lambda m: m.star(13),
    "random64": lambda m: m.random_graph(64, 3, seed=4),
    "digraph20": lambda m: m.from_adjacency(digraph(20, 6)),
}

# each op and its arguments, given to both sims in turn
OPS = [("put",), ("converge",), ("converge",), ("put",), ("capped", 1), ("capped", 2),
       ("put",), ("step", 1), ("put",), ("step", 3), ("put",), ("capped", 0), ("converge",),
       ("put",), ("capped", 3), ("step", 2), ("restore",), ("put",), ("converge",),
       ("step", 1)]


@pytest.fixture
def card_routes(monkeypatch):
    """Forces the card's routes; counts the graph passes and plain loops."""
    monkeypatch.setattr(PeerNetworkSim, "_card_routes", lambda self: True)
    seen = {"graph": 0, "plain": 0}
    for key, name in (("graph", "gossip_graph_packed"),
                      ("plain", "gossip_until_converged_packed")):
        real = getattr(pk, name)

        def counted(*args, _real=real, _key=key, **kw):
            seen[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(pk, name, counted)
    return seen


def assert_same(js, ps, what):
    got = table_to_numpy(ps.table)
    assert len(got) == len(js.table), what
    for a, b in zip(got, js.table):
        np.testing.assert_array_equal(a, np.asarray(b), what)
    assert ps.last_residual == js.last_residual, what
    assert ps.stats == js.stats, what


def play(js, ps, seed: int):
    """``OPS`` into both sims; everything compared after each op."""
    rng = np.random.default_rng(seed)
    p = ps.num_peers
    for i, (name, *args) in enumerate(OPS):
        what = f"op {i}: {name}{tuple(args)}"
        if name == "put":
            k = int(rng.integers(8, 48))
            peers, keys = rng.integers(0, p, k), rng.integers(0, 90, k)
            values = rng.integers(-40, 40, k)
            got = want = None
            for sim in (js, ps):
                sim.put_bulk(peers, [f"b/{int(x)}" for x in keys], values)
                sim.step(0)
        elif name == "converge":
            want, got = js.run_until_converged(), ps.run_until_converged()
        elif name == "capped":
            want, got = (sim.run_until_converged(max_rounds=args[0]) for sim in (js, ps))
        elif name == "step":
            want, got = js.step(args[0]), ps.step(args[0])
        else:
            for sim in (js, ps):
                sim.restore(sim.snapshot())
            assert ps._marks.columns() is None, what
            got = want = None
        assert got == want, what
        assert_same(js, ps, what)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_sims_match_the_reference(card_routes, layout, name):
    build = TOPOLOGIES[name]
    js = JaxSim(build(jtopo).num_peers, capacity=128, topology=build(jtopo), layout=layout)
    ps = PeerNetworkSim(js.num_peers, capacity=128, topology=build(topo), layout=layout,
                        device="cpu", use_kernels=True)
    assert ps._graph_pass_applies()
    play(js, ps, seed=len(name) + LAYOUTS.index(layout))
    assert card_routes["graph"] >= 10 and card_routes["plain"] == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_partition_heal_and_lossy_links(card_routes, layout):
    """A bridge cut at its bridge peer converges on each side; healed, the
    next converge merges the sides (the marks were settled under the cut
    topology); then rounds of step(1) over random one-way link losses, and
    the healed converge, as the reference's sims."""
    t, jt = topo.bridge((3, 3), 1), jtopo.bridge((3, 3), 1)
    js = JaxSim(t.num_peers, capacity=64, topology=jt, layout=layout)
    ps = PeerNetworkSim(t.num_peers, capacity=64, topology=t, layout=layout, device="cpu")
    for sim, whole in ((js, jt), (ps, t)):
        sim.topology = whole.drop_peer(t.num_peers - 1)
        sim.put(0, "left", 1)
        sim.put(3, "right", 2)
    assert ps.run_until_converged(max_rounds=10) == js.run_until_converged(max_rounds=10)
    assert_same(js, ps, "cut")
    assert ps.get(4, "left") is None
    for sim, whole in ((js, jt), (ps, t)):
        sim.topology = whole
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps, "healed")
    assert ps.get(4, "left") == 1 and ps.get(0, "right") == 2
    rng = np.random.default_rng(9)
    full = t.adjacency()
    for i in range(8):
        peer = int(rng.integers(t.num_peers))
        keep = rng.random(full.shape) < 0.5
        adj = full & keep
        for sim, m in ((js, jtopo), (ps, topo)):
            sim.put(peer, f"k{i}", i)
            sim.topology = m.from_adjacency(adj, name="lossy")
        assert ps.step(1) == js.step(1)
        assert_same(js, ps, f"lossy round {i}")
    for sim, whole in ((js, jt), (ps, t)):
        sim.topology = whole
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps, "lossy healed")


@pytest.mark.parametrize("heal", ["ring", "chain"])
@pytest.mark.parametrize("form,layout", [
    ("uncapped", "packed"), ("capped", "packed"), ("fast_forward", "packed"),
    ("reconcile", "packed"), ("reconcile", "dense")])
def test_partition_heals_into_a_ring_or_chain(card_routes, form, layout, heal):
    """A ring or chain of 8 peers converges; peer 3 is cut off and a write
    lands on each side; the cut topology converges (on the packed layout
    through the graph pass) or is reconciled. Healed, the next converge
    (uncapped: the column pass; capped at the diameter: the stripe loop;
    fast_forward(P + 1): the frontier route) must still pass the written
    column, as the reference's sims given the same calls."""
    p = 8
    js = JaxSim(p, capacity=64, topology=heal, layout=layout)
    ps = PeerNetworkSim(p, capacity=64, topology=heal, layout=layout, device="cpu",
                        use_kernels=True)
    for sim in (js, ps):
        sim.put(5, "k0", 0)
    assert ps.run_until_converged() == js.run_until_converged()
    for sim, m in ((js, jtopo), (ps, topo)):
        sim.topology = getattr(m, heal)(p).drop_peer(3)
        sim.put(3, "k1", "isolated")
        sim.put(0, "k1", 1)
    if form == "reconcile":
        assert ps.reconcile() == js.reconcile()
    else:
        assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps, "cut")
    assert ps.get(3, "k1") != ps.get(0, "k1")
    for sim, m in ((js, jtopo), (ps, topo)):
        sim.topology = getattr(m, heal)(p)
    if form == "capped":
        got, want = (sim.run_until_converged(max_rounds=sim.topology.diameter)
                     for sim in (ps, js))
    elif form == "fast_forward":
        assert ps._fast_forward_route() == "frontier"
        got, want = ps.fast_forward(p + 1), js.fast_forward(p + 1)
    else:
        got, want = ps.run_until_converged(), js.run_until_converged()
    assert got == want
    assert_same(js, ps, "healed")
    if form != "capped":
        assert ps.tables_equal() and ps.get(3, "k1") == ps.get(0, "k1")


def test_settled_converge_takes_one_round(card_routes):
    ps = PeerNetworkSim(11, capacity=64, topology=topo.bridge((5, 5), 1), layout="packed",
                        device="cpu")
    ps.put(3, "a", 1)
    assert ps.run_until_converged() >= 2
    before = ps.stats["gossip_rounds"]
    assert ps.run_until_converged() == 1 and ps.last_residual == 0
    assert ps.stats["gossip_rounds"] == before + 1
    assert not ps._marks.columns().any()


def settled_table(rng, nf: int, p: int, n: int, nb: np.ndarray):
    """A random table of live entries at its fixed point over ``nb``."""
    if nf == 3:
        cls = rng.integers(1, 8, (p, n))
        fields = [rng.integers(-2, 2, (p, n)), rng.integers(-2, 2, (p, n)),
                  (cls << pk.CV_SHIFT) | rng.integers(0, 4, (p, n))]
    else:
        rank = rng.integers(1, 9, (p, n))
        fields = [rank] if nf == 1 else [rank, (1 << pk.CV_SHIFT) | rank]
    kind = {3: pk.PackedTable, 2: RankTable, 1: Rank1Table}[nf]
    table = kind(*(torch.from_numpy(f.astype(np.int32)) for f in fields))
    pk.gossip_graph_packed(table, pk.GraphPlan(nb), None, 4 * p)
    return table


def with_holes(nb: np.ndarray, seed: int) -> np.ndarray:
    """``nb`` with about a quarter of its entries knocked out, -1 in the
    middle of rows."""
    nb = nb.copy()
    nb[np.random.default_rng(seed).random(nb.shape) < 0.25] = -1
    return nb


@pytest.mark.parametrize("nf", [3, 2, 1])
@pytest.mark.parametrize("holes", [False, True], ids=["whole", "holes"])
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_pass_matches_the_whole_table_loop(name, holes, nf):
    """Dirty columns of a settled table (one or three rows written, some
    columns of a group clean), or every column of a random table: the pass
    at caps 1, 2, 3 and uncapped gives the whole-table loop's table,
    rounds and last count, and each round's count."""
    rng = np.random.default_rng(len(name) + 10 * nf + holes)
    nb = TOPOLOGIES[name](topo).neighbors
    if holes:
        nb = with_holes(nb, len(name))
    p, n = nb.shape[0], 64
    base = settled_table(rng, nf, p, n, nb)
    dirty = np.zeros(n, dtype=bool)
    dirty[rng.choice(n, 9, replace=False)] = True
    for c in np.flatnonzero(dirty):
        for r in rng.integers(0, p, int(rng.integers(1, 4))):
            for f in base:
                f[r, c] = f[r, c] + int(rng.integers(1, 3)) * (1 if nf < 3 else 0)
            if nf == 3:
                base[2][r, c] = (int(rng.integers(1, 8)) << pk.CV_SHIFT) | int(rng.integers(5))
    topology = topo.Topology("custom", p, nb.astype(np.int32))
    for seed, cap in [(dirty, c) for c in (1, 2, 3, 4 * p)] + [(None, 4 * p)]:
        table = type(base)(*(f.clone() for f in base))
        if seed is None:
            table = type(base)(*(torch.randint_like(f, 1, 9) for f in table))
        want = type(base)(*(f.clone() for f in table))
        loop = pk.gossip_until_converged_packed(type(base)(*(f.clone() for f in table)),
                                                topology, cap)
        counts = []
        rounds, last = 0, 1
        while rounds < cap and last > 0:
            want, c = pk.gossip_round_generic_packed(want, nb)
            counts.append(int(c))
            rounds, last = rounds + 1, int(c)
        got, g_rounds, g_last, g_counts = pk.gossip_graph_packed(
            table, pk.GraphPlan(nb), seed, cap)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (seed is None, cap)
        assert (g_rounds, g_last, g_counts) == (rounds, last, counts), (seed is None, cap)
        assert loop[1:] == (rounds, last)


def test_plan_groups_the_bridge_slots():
    """The north star's bridge: every row active in slots 0-3, the gateways
    and bridges in 4-7, and slots 8-203 (the bridges pulling gateways, none
    of which they write) one group, a warp a row."""
    plan = pk.GraphPlan(topo.bridge((5,) * 204, 4).neighbors)
    assert plan.edges == 5712 and plan.max_degree == 204
    assert plan.sched.tolist() == ([[k, k + 1, 1024, 0] for k in range(4)]
                                   + [[k, k + 1, 208, 0] for k in range(4, 8)]
                                   + [[8, 204, 4, 1]])
    assert (pk.graph_pass_fits(1024, 3), pk.graph_pass_fits(2336, 3),
            pk.graph_pass_fits(2337, 3), pk.graph_pass_fits(3072, 1),
            pk.graph_pass_fits(3073, 1)) == (True, True, False, True, False)
    groups, masks = pk.graph_work(np.eye(32, dtype=bool)[[1, 3, 17]].any(0), 32)
    assert groups.tolist() == [0, 2] and masks.tolist() == [0b1010, 0b10]
    assert pk.graph_work(None, 16)[1].tolist() == [255, 255]


@pytest.mark.parametrize("name", ["bridge6x5+2", "star13", "digraph20"])
def test_graph_rounds_reference(name):
    """perfbench's plain reference gives the port's plain loop's table,
    rounds and last count on packed tables, capped and not."""
    rng = np.random.default_rng(3)
    nb = TOPOLOGIES[name](topo).neighbors
    p = nb.shape[0]
    table = settled_table(rng, 3, p, 48, nb)
    for f, g in zip(table, settled_table(rng, 3, p, 48, nb)):
        f[:, ::3] = g[:, ::3]
    table = pk.PackedTable(*(torch.roll(f, 1, 0) for f in table))
    for cap in (1, 2, 4 * p):
        topology = topo.Topology("custom", p, nb)
        want, rounds, last = pk.gossip_until_converged_packed(
            pk.PackedTable(*(f.clone() for f in table)), topology, cap)
        got, g_rounds, g_last = graph_rounds.rounds(nb, list(table), cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (g_rounds, g_last) == (rounds, last)


def test_bridge_spec():
    spec = {"kind": "bridge", "clusters": 204, "cluster_size": 5, "bridge_peers": 4}
    sim = PeerNetworkSim(1024, capacity=16, topology=spec, layout="packed", device="cpu")
    want = topo.bridge((5,) * 204, 4)
    assert np.array_equal(sim.topology.neighbors, want.neighbors)
    assert (sim.topology.kind, sim.topology.diameter) == ("generic", 4)
    for bad in ({**spec, "clusters": 203}, {**spec, "bridge_peers": 5},
                {**spec, "cluster_size": "5"}, {**spec, "extra": 1},
                {"kind": "bridge", "clusters": 204, "cluster_size": 5}, {"clusters": 204},
                {"kind": "star"}):
        with pytest.raises(ValueError):
            PeerNetworkSim(1024, capacity=16, topology=bad, layout="packed", device="cpu")
    # the string forms keep their meaning
    assert PeerNetworkSim(11, capacity=16, topology="bridge", device="cpu",
                          layout="packed").topology.neighbors.shape == (11, 5)
