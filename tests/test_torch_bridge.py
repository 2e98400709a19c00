"""The db <-> engine bridge, the sim's serializer facade and the serving
warm-up, on both packages: the same seeded stores and writes go into the
reference's Bullets and sims (JAX, CPU) and the port's (device="cpu").

* ``load_bullet_into_sim``, ``dump_sim_into_bullet`` and ``sim_from_bullet``
  give the same tables (through ``convert.py``), reads and stores.
* ``attach_live_bridge``: staging, ``pump``, ``backlog``, ``flush``, view
  queries under each refresh policy, stacked bridges (one db into two
  sims, two dbs into one sim) and detach order (in order and out of it),
  step by step against a reference sim mirrored from a reference Bullet
  given the same writes.
* ``export_to_{json,csv,xml}`` / ``import_from_{json,csv,xml}``: the same
  text (timestamps aside) and the same converged tables.
* ``warm_apply_buckets``: the reference's count on every layout, on one
  device and on a mesh, and an unchanged table; ``_pad_flat_ops`` is the
  reference's.

Tolerance: exact."""

import copy
import re

import numpy as np
import pytest
import torch

import bullet_tpu
import bullet_tpu_torch
from bullet_tpu.models import bridge as jbridge
from bullet_tpu.models import netsim as jns
from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.models import bridge
from bullet_tpu_torch.models import netsim as ns
from test_torch_netsim import paths_of

torch.set_num_threads(2)

PACKAGES = (bullet_tpu, bullet_tpu_torch)
STAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?|\"timestamp\": ?\d+")


def assert_same(jax_sim, port_sim):
    got, want = table_to_numpy(port_sim.table), [np.asarray(f) for f in jax_sim.table]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def sims(p, **kw):
    """A reference sim and a port sim of one configuration."""
    return JaxSim(p, **kw), PeerNetworkSim(p, device="cpu", **kw)


@pytest.fixture
def dbs():
    """Make (reference, port) Bullet pairs, closed afterwards."""
    made = []

    def make():
        pair = tuple(bt.create({"storage": False, "disable_network": True}) for bt in PACKAGES)
        made.extend(pair)
        return pair

    yield make
    for b in made:
        b.close()


def tree(rng, depth=3):
    if depth == 0 or rng.random() < 0.3:
        return [int(rng.integers(-50, 50)), f"s{int(rng.integers(20))}", True, False, None,
                float(rng.integers(-8, 8)) / 4, [1, "a"], ""][int(rng.integers(8))]
    return {f"k{int(rng.integers(5))}": tree(rng, depth - 1)
            for _ in range(int(rng.integers(1, 4)))}


def seed_store(seed, *dbs_):
    """The same seeded records into each Bullet (some overwritten)."""
    rng = np.random.default_rng(seed)
    records = [(f"{['users', 'items', 'meta'][int(rng.integers(3))]}/r{int(rng.integers(30))}",
                tree(rng)) for _ in range(60)]
    for db in dbs_:
        for path, value in records:
            db.get(path).put(copy.deepcopy(value))  # a db keeps what it is given


@pytest.mark.parametrize("topology,mesh", [("ring", None), ("mesh", None), ("ring", 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sim_from_bullet_and_dump_match_reference(dbs, seed, topology, mesh):
    jb, pb = dbs()
    seed_store(seed, jb, pb)
    assert pb.store == jb.store
    js = jbridge.sim_from_bullet(jb, 8, topology=topology, mesh_devices=mesh)
    ps = bridge.sim_from_bullet(pb, 8, topology=topology, mesh_devices=mesh, device="cpu")
    assert ps.capacity == js.capacity == max(128, 2 * bridge._count_leaves(pb.store))
    assert ps.layout == "dense" and ps.tables_equal()
    assert_same(js, ps)
    assert paths_of(ps) == paths_of(js)
    for peer in (0, 7):
        assert ps.get(peer) == js.get(peer)
    jo, po = dbs()
    assert bridge.dump_sim_into_bullet(ps, po, peer=7) == jbridge.dump_sim_into_bullet(
        js, jo, peer=7)
    assert po.store == jo.store == jb.store
    assert sorted(po.meta) == sorted(jo.meta)


@pytest.mark.parametrize("layout", ["dense", "packed", "rank", "rank1"])
def test_load_bullet_into_sim_matches_reference(dbs, layout):
    jb, pb = dbs()
    seed_store(2, jb, pb)
    js, ps = sims(6, capacity=128, topology="chain", layout=layout)
    n = bridge.load_bullet_into_sim(pb, ps, peer=2)
    assert n == jbridge.load_bullet_into_sim(jb, js, peer=2) > 100
    assert ps.stats["ops_enqueued"] == js.stats["ops_enqueued"] == n
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps)
    assert ps.get(5) == js.get(5) == pb.store


# ------------------------------------------------------------ live bridges


def live_ops(seed, n=40):
    """A seeded stream of db writes: records, leaf overwrites and lower
    values (which the mirror's value order keeps out)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        i = int(rng.integers(25))
        kind = int(rng.integers(3))
        if kind == 0:
            ops.append((f"cat/item{i:03d}", {"price": float(rng.integers(0, 400)),
                                             "tier": ["gold", "std"][int(rng.integers(2))]}))
        elif kind == 1:
            ops.append((f"cat/item{i:03d}/price", float(rng.integers(0, 400))))
        else:
            ops.append((f"cat/item{i:03d}/tags", tree(rng, 2)))
    return ops


def view_reads(view):
    return (view.count("cat", "tier", "gold"), view.equals("cat", "tier", "std"),
            view.range("cat", "price", 100.0, 300.0), view.get("cat"))


def test_live_bridge_matches_reference(dbs):
    """Staging, pump, backlog, views under each refresh policy and flush,
    write by write, against the reference; the mirror is a rank1 sim."""
    jb, pb = dbs()
    js, ps = sims(4, capacity=64, layout="rank1")
    hj, hp = jbridge.attach_live_bridge(jb, js, peer=1), bridge.attach_live_bridge(pb, ps, peer=1)
    views = {r: (hj.view(r), hp.view(r)) for r in ("apply", "converge", None)}
    with pytest.raises(ValueError):
        hp.view("later")
    rng = np.random.default_rng(4)
    for i, (path, value) in enumerate(live_ops(3, 60)):
        for db in (jb, pb):
            db.get(path).put(copy.deepcopy(value))  # a db keeps what it is given
        assert hp.backlog() == hj.backlog()
        what = int(rng.integers(5))
        if what == 0:
            assert hp.pump() == hj.pump()
        elif what == 1:
            assert hp.flush() == hj.flush()
            assert ps.tables_equal()
        elif what in (2, 3):
            refresh = ("apply", "converge", None)[int(rng.integers(3))]
            vj, vp = views[refresh]
            assert view_reads(vp) == view_reads(vj), (i, refresh)
        assert hp.backlog() == hj.backlog()
        assert ps.stats["ops_enqueued"] == js.stats["ops_enqueued"]
        if what != 4:
            assert_same(js, ps)
    vj, vp = views["apply"]
    assert vp.count("cat", "tier", "gold") == vj.count("cat", "tier", "gold") == sum(
        1 for r in pb.store["cat"].values() if r.get("tier") == "gold")
    assert vp.filter("cat", lambda r, k: r.get("price", 0) > 200) == vj.filter(
        "cat", lambda r, k: r.get("price", 0) > 200)
    assert vp.find("cat", lambda r, k: r.get("tier") == "std") == vj.find(
        "cat", lambda r, k: r.get("tier") == "std")
    assert vp.map("cat", lambda r, k: k) == vj.map("cat", lambda r, k: k)
    hj.detach()
    hp.detach()
    for db in (jb, pb):
        db.get("cat/after").put({"tier": "gold"})  # not mirrored any more
    assert hp.flush() == hj.flush()
    assert_same(js, ps)
    assert ps.get(0, "cat/after") is None


def test_stacked_bridges_and_detach_order(dbs):
    """One db into two sims, two dbs into one sim at two peers (any
    handle's pump drains every bridge of its sim), detach in order and out
    of order, each step against the reference."""
    (ja, pa), (jb2, pb2) = dbs(), dbs()
    (j1, p1), (j2, p2) = sims(4, capacity=64, layout="packed"), sims(4, capacity=64)
    handles = {}
    for key, (db_j, db_p, sj, sp, peer) in {
        "a1": (ja, pa, j1, p1, 0), "a2": (ja, pa, j2, p2, 0), "b1": (jb2, pb2, j1, p1, 3),
    }.items():
        handles[key] = (jbridge.attach_live_bridge(db_j, sj, peer),
                        bridge.attach_live_bridge(db_p, sp, peer))
    assert len(p1._bridge_stages) == len(j1._bridge_stages) == 2

    def write(ops, which):
        for path, value in ops:
            for db in which:
                db.get(path).put(copy.deepcopy(value))

    def check(*pairs):
        assert [hp.backlog() for _, hp in handles.values()] == [
            hj.backlog() for hj, _ in handles.values()]
        for sj, sp in pairs:
            assert_same(sj, sp)

    ops = live_ops(7, 30)
    write(ops[:10], (ja, pa))
    write(ops[10:20], (jb2, pb2))
    check((j1, p1), (j2, p2))
    hj, hp = handles["a1"]
    assert hp.pump() == hj.pump() > 0  # both of p1's bridges drain
    check((j1, p1), (j2, p2))
    assert handles["b1"][1].backlog() == 0 and handles["a2"][1].backlog() > 0
    assert hp.flush() == hj.flush()
    hj2, hp2 = handles["a2"]
    assert hp2.view().get("cat") == hj2.view().get("cat")
    check((j1, p1), (j2, p2))
    # out of order: a1 restores the original hook, so a2 stops mirroring;
    # detaching a2 then re-installs a1's forwarder, whose stage no pump sees
    for key in ("a1", "a2"):
        hj, hp = handles[key]
        write(ops[20 + (key == "a2") * 5:25 + (key == "a2") * 5], (ja, pa))
        hj.detach()
        hp.detach()
        check((j1, p1), (j2, p2))
    write(ops[:5], (ja, pa))
    check((j1, p1), (j2, p2))
    assert handles["a1"][1].backlog() == handles["a1"][0].backlog() > 0
    for sj, sp in ((j1, p1), (j2, p2)):
        assert sp.run_until_converged() == sj.run_until_converged()
        assert_same(sj, sp)
    hj, hp = handles["b1"]
    hj.detach()
    hp.detach()
    assert p1._bridge_stages == [] and j1._bridge_stages == []


# ---------------------------------------------------- export and import


@pytest.mark.parametrize("layout", ["dense", "packed", "rank1"])
def test_export_import_match_reference(layout):
    js, ps = sims(5, capacity=128, topology="ring", layout=layout)
    rng = np.random.default_rng(6)
    for s in (js, ps):
        r = np.random.default_rng(6)
        for i in range(20):
            s.put(int(r.integers(5)), f"people/p{i}", {
                "name": f"n{int(r.integers(9))}", "age": int(r.integers(1, 90)),
                "ok": bool(r.integers(2))})
        s.run_until_converged()
    peer = int(rng.integers(5))
    outputs = {}
    for fmt in ("json", "csv", "xml"):
        got = getattr(ps, f"export_to_{fmt}")(peer, "people")
        want = getattr(js, f"export_to_{fmt}")(peer, "people")
        assert STAMP.sub("", got) == STAMP.sub("", want), fmt
        outputs[fmt] = got
    assert ps.export_to_json(0) != ps.export_to_json(0, "people")
    for fmt, target in (("json", "copy"), ("csv", "csv"), ("xml", "xml")):
        jt, pt = sims(3, capacity=64, topology="chain", layout=layout)
        rj = getattr(jt, f"import_from_{fmt}")(1, outputs[fmt], target)
        rp = getattr(pt, f"import_from_{fmt}")(1, outputs[fmt], target)
        assert rp["success"] and rj["success"]
        assert {k: v for k, v in rp.items() if k != "timestamp"} == {
            k: v for k, v in rj.items() if k != "timestamp"}
        assert pt.run_until_converged() == jt.run_until_converged()
        assert_same(jt, pt)
        assert pt.get(2, target) == jt.get(2, target)
    for s in sims(2, capacity=64, layout=layout):
        result = s.import_from_json(0, "{not json", "x")
        assert not result["success"] and s.stats["ops_enqueued"] == 0


# ------------------------------------------------------------ warm buckets


def test_pad_flat_ops_matches_reference():
    rng = np.random.default_rng(8)
    for k in (0, 1, 37, 64, 65, 300):
        for rows in (3, 4, 5):
            reduced = tuple(rng.integers(0, 50, k).astype(np.int32) for _ in range(rows))
            for bucket in (64, 256):
                got = ns._pad_flat_ops(reduced, 4, 100, min_bucket=bucket)
                want = jns._pad_flat_ops(reduced, 4, 100, min_bucket=bucket)
                assert len(got) == len(want) == rows
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype


@pytest.mark.parametrize("mesh", [None, 4], ids=["one", "mesh4"])
@pytest.mark.parametrize("layout", ["dense", "packed", "rank", "rank1"])
def test_warm_apply_buckets_match_reference(layout, mesh):
    js, ps = sims(8, capacity=128, layout=layout, mesh_devices=mesh)
    for s in (js, ps):
        s.put(0, "x/a", 5)
        s.put(5, "x/b", "hello")
        s.step(1)
    before = table_to_numpy(ps.table)
    applied = ps.stats["ops_applied"]
    for max_ops in (1 << 10, 100, 64, 63):
        assert ps.warm_apply_buckets(max_ops) == js.warm_apply_buckets(max_ops)
    assert ps.warm_apply_buckets(1 << 10) == (0 if layout == "dense" else 5)
    for a, b in zip(table_to_numpy(ps.table), before):
        np.testing.assert_array_equal(a, b)
    assert_same(js, ps)
    assert ps.stats["ops_applied"] == applied
    assert ps.get(0, "x/a") == 5 and ps.get(5, "x/b") == "hello"
