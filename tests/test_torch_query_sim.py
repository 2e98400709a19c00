"""The sim's queries: ``equals``, ``range``, ``count``, ``filter``,
``find``, ``map`` and the SimPeer facade of a port PeerNetworkSim
(device="cpu") against the reference's PeerNetworkSim given the same puts,
on every layout (dense in reference, lww and lean mode; packed, rank,
rank1), on ring and chain, after step(1) (rows differ from peer to peer)
and after the converge, on 4- and 8-shard meshes with and without
use_shard_map against the reference's mesh sims; a probe of a value
never interned, followed by puts (interners and tables stay the
reference's); rank1 with an empty RankIndex; and the query cases of
test_netsim_convergence.py, test_rank_sim.py, test_packed.py and
test_review_regressions.py. Tolerance: exact (the same lists, paths in
the same order, the same ints)."""

import jax
import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops import predicates as jp
from bullet_tpu_torch import P, PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy

torch.set_num_threads(2)

ROLES = ("admin", "user", "editor")
CATEGORIES = ("electronics", "accessories", "furniture", "books")


def records(seed, users=24, products=8, scores=16):
    """The shape of the upstream query fixture (examples/query_example.py):
    users {name, age, active, role}, products {name, price, stock,
    category} and leaf-form scores, drawn from ``seed``; a few users lack
    an age or carry a bool one."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(users):
        rec = {"name": f"n{int(rng.integers(8))}", "age": int(rng.integers(18, 81)),
               "active": bool(rng.integers(2)), "role": ROLES[int(rng.integers(3))]}
        if i % 7 == 3:
            del rec["age"]
        elif i % 11 == 5:
            rec["age"] = bool(rng.integers(2))
        out.append((f"users/u{i}", rec))
    for i in range(products):
        out.append((f"products/p{i}", {
            "name": f"item{i}", "price": float(np.round(rng.uniform(5, 900), 2)),
            "stock": int(rng.integers(0, 60)), "category": CATEGORIES[int(rng.integers(4))]}))
    for i in range(scores):
        out.append((f"scores/s{i}", int(rng.integers(0, 100))))
    return out


def load(sim, seed, p):
    """Every record at a random peer, then a few fields overwritten from
    other peers (conflicts to resolve), part of it through put_bulk."""
    rng = np.random.default_rng(seed + 1)
    recs = records(seed)
    for path, rec in recs[: len(recs) // 2]:
        sim.put(int(rng.integers(p)), path, rec)
    leaves = []
    for path, rec in recs[len(recs) // 2:]:
        leaves += ([(f"{path}/{k}", v) for k, v in rec.items()] if isinstance(rec, dict)
                   else [(path, rec)])
    sim.put_bulk(rng.integers(0, p, len(leaves)), [a for a, _ in leaves], [v for _, v in leaves])
    for i in rng.integers(0, 24, 6):
        sim.put(int(rng.integers(p)), f"users/u{i}/role", ROLES[int(rng.integers(3))])
        sim.put(int(rng.integers(p)), f"users/u{i}/age", int(rng.integers(18, 81)))
    sim.put(int(rng.integers(p)), "products/p1/price", 100.0)
    sim.remove(int(rng.integers(p)), "users/u2/role")


def query_set(sim, P, peer):
    """One answer per query form, in a fixed order."""
    view = sim.peer(peer)
    return [
        sim.equals(peer, "users", "role", "admin"),
        sim.equals(peer, "users", "active", True),
        sim.equals(peer, "users", "age", True),
        sim.range(peer, "users", "age", 30, 39),
        sim.range(peer, "products", "price", 100.0, 500.0),
        sim.equals(peer, "scores", 42),
        sim.range(peer, "scores", 10, 60.5),
        sim.count(peer, "scores", 42),
        sim.count(peer, "users", "role", "user"),
        sim.count(peer, "users", "nofield", "user"),
        sim.count(peer, "nowhere", "role", "user"),
        sim.equals(peer, "users", "role", "nobody"),
        sim.range(peer, "users", "nofield", 0, 1),
        sim.filter(peer, "users", (P["age"] >= 30) & (P["role"] == "user")),
        sim.count(peer, "users", ~P.has("age")),
        sim.count(peer, "users", (P["age"] > 40) | (P["active"] == False)),  # noqa: E712
        sim.filter(peer, "scores", P.value() > 50),
        sim.find(peer, "products", P["price"] < 300),
        sim.find(peer, "products", P["price"] > 1e9),
        sim.filter(peer, "users", lambda v, k: isinstance(v, dict) and v.get("age", 0) is True),
        sim.find(peer, "users", lambda v: isinstance(v, dict) and v.get("role") == "editor"),
        sim.map(peer, "products", lambda v, k: (k, v.get("category") if isinstance(v, dict)
                                               else v)),
        sim.count(peer, "users", P["role"] == "admin"),
        view.equals("users", "role", "editor"),
        view.range("users", "age", 18, 25),
        view.count("users", "active", False),
        view.count("scores", 7),
        view.filter("users", P["age"].between(20, 30)),
        view.find("users", P["name"] == "n3"),
        view.map("scores", lambda v: v),
    ]


def assert_same_tables(js, ps):
    for a, b in zip(table_to_numpy(ps.table), js.table):
        np.testing.assert_array_equal(a, np.asarray(b))


def assert_same_queries(js, ps, peers):
    for peer in peers:
        got, want = query_set(ps, P, peer), query_set(js, jp.P, peer)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a == b, f"peer {peer} query {i}: {a} != {b}"


def run_pair(js, ps, p, seed):
    for s in (js, ps):
        load(s, seed, p)
    assert js.step(1) == ps.step(1)
    assert_same_tables(js, ps)
    assert_same_queries(js, ps, (0, p // 2, p - 1))
    assert js.run_until_converged() == ps.run_until_converged()
    assert_same_tables(js, ps)
    assert_same_queries(js, ps, (0, p - 1))


@pytest.mark.parametrize("seed,layout,mode,lean,topology", [
    (0, "dense", "reference", False, "ring"),
    (1, "dense", "reference", False, "chain"),
    (2, "dense", "lww", False, "ring"),
    (3, "dense", "lww", False, "chain"),
    (4, "dense", "reference", True, "ring"),
    (5, "dense", "reference", True, "chain"),
    (6, "packed", "reference", False, "ring"),
    (7, "packed", "reference", False, "chain"),
    (8, "rank", "reference", False, "ring"),
    (9, "rank", "reference", False, "chain"),
    (10, "rank1", "reference", False, "ring"),
    (11, "rank1", "reference", False, "chain"),
])
def test_queries_match_reference(seed, layout, mode, lean, topology):
    p = 12
    kw = dict(capacity=256, topology=topology, mode=mode, lean_gossip=lean, layout=layout)
    js = JaxSim(p, use_pallas=True, **kw)
    ps = PeerNetworkSim(p, device="cpu", use_kernels=True, **kw)
    run_pair(js, ps, p, seed)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("layout", ["dense", "packed", "rank", "rank1"])
@pytest.mark.parametrize("shards,spmd", [(4, False), (4, True), (8, False), (8, True)])
def test_mesh_queries_match_reference(layout, shards, spmd):
    """Each query reads the row from the shard that owns the peer."""
    p = 16
    kw = dict(capacity=256, topology="ring", layout=layout, mesh_devices=shards,
              use_shard_map=spmd)
    js = JaxSim(p, **kw)
    ps = PeerNetworkSim(p, device="cpu", **kw)
    run_pair(js, ps, p, seed=shards + 10 * spmd)


def interner_state(sim):
    vals = sim.host.values
    return (len(vals), vals.epoch, [a.tolist() for a in vals.key_table()],
            len(sim.host.paths), sim.capacity)


@pytest.mark.parametrize("layout", ["dense", "packed", "rank", "rank1"])
def test_novel_probes_then_puts_keep_state_identical(layout):
    """A query interns its probe before the table syncs: a new string may
    re-key the table, and the puts after it land on the same state."""
    pair = (JaxSim(4, capacity=16, layout=layout),
            PeerNetworkSim(4, capacity=16, layout=layout, device="cpu"))
    for s in pair:
        for i in range(6):
            s.put(i % 4, f"users/u{i}", {"name": f"m{i:02d}", "age": 20 + i})
        s.run_until_converged()
    answers = []
    for s, Pm in zip(pair, (jp.P, P)):
        answers.append([
            s.equals(0, "users", "name", "m025"),  # between interned strings
            s.count(1, "users", "name", "a-first"),
            s.filter(2, "users", Pm["name"] == "zz-last"),
            s.count(3, "users", Pm["name"] == "m03"),
            s.equals(0, "users", "age", 99.5),
        ])
        # probes that halve one gap of the string order until it respreads:
        # the table re-keys before the scans that follow
        answers[-1] += [s.count(0, "users", "name", "m02" + "0" * k) for k in range(1, 70)]
        answers[-1].append(s.equals(1, "users", "name", "m03"))
        for i in range(6, 20):  # past the capacity: the table grows
            s.put(i % 4, f"users/u{i}", {"name": f"m{i:02d}", "age": 20 + i})
        s.put(1, "users/u1/name", "a-first")
    assert answers[0] == answers[1]
    assert answers[1][-1] == ["users/u3"] and pair[1].host.values.epoch > 0
    assert interner_state(pair[1]) == interner_state(pair[0])
    for s in pair:
        s.run_until_converged()
    assert_same_tables(*pair)
    assert interner_state(pair[1]) == interner_state(pair[0])
    assert_same_queries(*pair, (0, 3))


def test_rank1_empty_rank_index():
    """Paths interned, nothing applied: the view is all-absent, and a
    negation matches every interned child, as in the reference."""
    pair = (JaxSim(4, capacity=32, layout="rank1"),
            PeerNetworkSim(4, capacity=32, layout="rank1", device="cpu"))
    for s in pair:
        s.put(0, "users/u1", {"age": 30, "role": "admin"})
        s.put(1, "scores/a", 5)
    js, ps = pair
    assert len(ps.rank_index) == 0
    assert ps.filter(0, "users", ~P.has("age")) == js.filter(0, "users", ~jp.P.has("age"))
    assert ps.count(0, "users", P["age"] > 1) == js.count(0, "users", jp.P["age"] > 1) == 0
    assert ps.equals(0, "users", "role", "admin") == [] == js.equals(0, "users", "role", "admin")
    assert ps.range(0, "scores", 0, 10) == js.range(0, "scores", 0, 10) == []
    assert ps.filter(1, "scores", P.value() < 9) == js.filter(1, "scores", jp.P.value() < 9)
    for s in pair:
        s.step(1)
    assert ps.equals(1, "scores", 5) == js.equals(1, "scores", 5) == ["scores/a"]


def test_engine_queries():
    """test_netsim_convergence.py's query case, on a full mesh."""
    pair = (JaxSim(4, capacity=128, topology="mesh"),
            PeerNetworkSim(4, capacity=128, topology="mesh", device="cpu"))
    users = {
        "u1": {"name": "Alice", "age": 28, "role": "admin"},
        "u2": {"name": "Bob", "age": 35, "role": "user"},
        "u3": {"name": "Carol", "age": 42, "role": "user"},
    }
    for s in pair:
        for uid, data in users.items():
            s.put(0, f"users/{uid}", data)
        s.run_until_converged()
    js, sim = pair
    assert sim.equals(2, "users", "role", "user") == ["users/u2", "users/u3"]
    assert sim.range(1, "users", "age", 30, 45) == ["users/u2", "users/u3"]
    assert sim.count(3, "users", "role", "admin") == 1
    assert sim.count(3, "users", "role", "user") == 2
    assert sim.count(3, "users", "role", "nobody") == 0
    assert sim.count(3, "nosuch", "role", "user") == 0
    assert sim.count(3, "users", "nofield", "user") == 0
    for s in pair:
        s.put(0, "scores/a", 10)
        s.put(0, "scores/b", 10)
        s.run_until_converged()
    assert sim.count(2, "scores", 10) == 2 == js.count(2, "scores", 10)
    assert sim.count(2, "scores", 11) == 0
    assert sim.filter(0, "users", lambda v, k: v.get("age", 0) > 40) == ["users/u3"]
    assert sim.find(0, "users", lambda v, k: v.get("name") == "Bob") == "users/u2"
    assert sorted(sim.map(0, "users", lambda v, k: v.get("name"))) == ["Alice", "Bob", "Carol"]


@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
def test_rank_native_query_edge_cases(layout):
    """test_rank_sim.py's rank1 edge cases (unseen values, bool against 0,
    uninterned range bounds, empty intervals), on each packed-family
    layout against the reference's same layout."""
    pair = (JaxSim(4, capacity=256, layout=layout),
            PeerNetworkSim(4, capacity=256, layout=layout, device="cpu"))
    rng = np.random.default_rng(21)
    vals = [0, False, True, 1, -0.5, 2.25, 7, 1e300, "x", None, 3.5]
    ops = [(int(rng.integers(0, 4)), f"q/i{int(rng.integers(0, 20))}/v",
            vals[int(rng.integers(0, len(vals)))]) for _ in range(120)]
    for s in pair:
        for op in ops:
            s.put(*op)
        s.run_until_converged()
    js, ps = pair
    for probe in vals + [99, "unseen", 2.250001]:
        assert ps.equals(0, "q", "v", probe) == js.equals(0, "q", "v", probe), probe
        assert ps.count(0, "q", "v", probe) == js.count(0, "q", "v", probe), probe
    for lo, hi in [(0, 1), (-1, 0), (0.5, 3), (-1e309, 1e309), (5, 4), (2.25, 2.25),
                   (1e299, 1e301)]:
        assert ps.range(0, "q", "v", lo, hi) == js.range(0, "q", "v", lo, hi), (lo, hi)
    for s in pair:
        s.put(0, "r/leaf", 5)
        s.run_until_converged()
    assert ps.equals(1, "r", 5) == js.equals(1, "r", 5) == ["r/leaf"]
    assert ps.range(1, "r", 4, 6) == js.range(1, "r", 4, 6)
    assert ps.count(1, "r", 5) == js.count(1, "r", 5) == 1


def test_packed_strings_rekey_and_queries():
    """test_packed.py: string interning re-keys the packed table, and the
    queries read the re-keyed rows."""
    sim = PeerNetworkSim(4, capacity=64, topology="ring", layout="packed", device="cpu")
    for i in range(20):
        sim.put(i % 4, f"users/m{i}/name", f"u{i:02d}")
        sim.put(i % 4, f"users/m{i}/age", float(20 + i))
    sim.run_until_converged()
    assert sim.tables_equal()
    assert sim.equals(0, "users", "name", "u07") == ["users/m7"]
    assert sim.range(2, "users", "age", 25, 27) == ["users/m5", "users/m6", "users/m7"]
    assert sim.count(1, "users", "name", "u03") == 1


@pytest.mark.parametrize("layout", ["dense", "packed", "rank1"])
def test_query_after_intern_growth(layout):
    """test_review_regressions.py: a query right after interning past the
    capacity grows the table first."""
    sim = PeerNetworkSim(2, capacity=8, topology="ring", layout=layout, device="cpu")
    for i in range(7):
        sim.put(0, f"k{i}", i)
    sim.run_until_converged()
    sim.put(0, "users/u1/age", 30)  # interns past the capacity, not yet stepped
    assert sim.equals(0, "users", "age", 30) == []
    assert sim.capacity == 16
    sim.run_until_converged()
    assert sim.equals(0, "users", "age", 30) == ["users/u1"]


def test_simpeer_equals_none_value():
    """test_review_regressions.py: three-argument equals with value=None
    queries for null, not the two-argument leaf form."""
    sim = PeerNetworkSim(2, capacity=64, topology="mesh", device="cpu")
    sim.put(0, "users/u1", {"age": None, "name": "x"})
    sim.put(0, "users/u2", {"age": 30, "name": "y"})
    sim.run_until_converged()
    assert sim.peer(1).equals("users", "age", None) == ["users/u1"]
    assert sim.peer(1).count("users", "age", None) == 1


def test_struct_cache_follows_paths_and_devices():
    """One PathStruct per device, rebuilt after new paths or growth; a
    mesh whose devices repeat shares one."""
    sim = PeerNetworkSim(8, capacity=8, layout="packed", mesh_devices=4, device="cpu")
    sim.put(0, "a/b", 1)
    sim.step(0)
    first = sim.host.struct("cpu")
    assert sim.host.struct(torch.device("cpu")) is first
    assert sim.equals(0, "a", 1) == ["a/b"] and list(sim.host._structs) == [torch.device("cpu")]
    sim.put(5, "a/c", 1)  # a new path: the cache empties
    assert not sim.host._structs
    sim.step(0)
    assert sim.equals(5, "a", 1) == ["a/c"]
    for i in range(10):  # growth
        sim.put(1, f"g/{i}", i)
    assert sim.equals(1, "g", 3) == []
    assert sim.host.struct("cpu").parent.shape[0] == sim.capacity == 16
