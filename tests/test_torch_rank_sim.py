"""The rank slice as a whole: the same puts go into a reference
PeerNetworkSim(layout="rank" | "rank1") (JAX, CPU) and the port's
(device="cpu"): put/put_bulk -> step -> run_until_converged ->
converged() -> fast_forward(k) -> reconcile -> get/get_bulk ->
snapshot/restore across a forced respread. Tables, stats, residuals, round
counts and reads must be identical. Also fast_forward on the packed layout
(tracking valid and invalid, and its frontier route), reference rank and
rank1 snapshots restored into the port, the fast_forward route table next
to the reference's, string rebalances and weak-topology reconcile.
Tolerance: exact."""

import random

import numpy as np
import pytest
import torch

import bullet_tpu.models.netsim as jns
from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops import packed as jpk
from bullet_tpu.ops import rank as jrk
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.ops import rank as rk
from bullet_tpu_torch.parallel import topology as topo
from test_torch_netsim import P, paths_of, writes

torch.set_num_threads(2)

VALS = ["alice", "bob", 3.5, -7, 0, True, False, None, "zed", 1e300, -0.5]


def port(p, layout, capacity=256, topology="ring", **kw):
    return PeerNetworkSim(p, capacity=capacity, topology=topology, layout=layout,
                          device="cpu", **kw)


def assert_same(jax_sim, port_sim, msg=""):
    assert len(port_sim.table) == len(jax_sim.table)
    for a, b in zip(table_to_numpy(port_sim.table), jax_sim.table):
        np.testing.assert_array_equal(a, np.asarray(b), msg)


def cv_of(sim):
    """The [P, N] cv array of any packed-family sim; rank1 rebuilds it
    through its own RankIndex (ranks of two sims may differ, values not)."""
    t = sim.table
    if hasattr(t, "cv"):
        return np.asarray(t.cv)
    vid = sim.rank_index.decode_ranks(np.asarray(t.rank))
    cls_map = sim.host.key_tables()[0]
    safe = np.maximum(vid, 0)
    return np.where(vid >= 0, (cls_map[safe].astype(np.int64) << 28) | safe, 0).astype(np.int32)


def seed_puts(sim, rng, n_writes=120, peers=None):
    for _ in range(n_writes):
        peer = int(rng.integers(0, peers or sim.num_peers))
        path = f"users/u{int(rng.integers(0, 15))}/f{int(rng.integers(0, 3))}"
        sim.put(peer, path, VALS[int(rng.integers(0, len(VALS)))])


def same_stats(js, ps):
    assert js.stats == {k: ps.stats.get(k, v) for k, v in js.stats.items()}


@pytest.mark.parametrize("layout,topology,use_kernels", [
    ("rank", "ring", True), ("rank", "chain", False),
    ("rank1", "ring", False), ("rank1", "chain", True),
])
def test_rank_slice_matches_reference(layout, topology, use_kernels):
    js = JaxSim(P, capacity=256, topology=topology, layout=layout)
    ps = port(P, layout, topology=topology, use_kernels=use_kernels)
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

    # fast_forward: 1 and 7 rounds mid-flight, 40 past a 16-peer fixed
    # point (its pass ends at residual 0) and 100 after late writes
    for s in sims:  # past the initial capacity: the table grows
        writes(s, 2, n_bulk=400)
    for k, late in ((1, False), (7, False), (40, True), (100, True)):
        if late:
            for s in sims:
                s.put(k % P, "late/x", k)
                s.put((k + 5) % P, "late/y", f"s{k}")
        assert js.fast_forward(k) == ps.fast_forward(k), k
        assert js.last_residual == ps.last_residual
        assert_same(js, ps, f"fast_forward({k})")
        same_stats(js, ps)
    assert ps.stats["windowed_rounds"] == 148 and ps.last_residual == 0
    assert js.converged() is ps.converged() is True
    for s in sims:
        writes(s, 3)
        s.reconcile()
    assert ps.capacity == js.capacity > 256
    same_stats(js, ps)
    assert_same(js, ps)
    assert js.converged() is ps.converged() is True
    names = paths_of(ps)
    assert names == paths_of(js)
    for peer in (0, 7, P - 1):
        assert ps.get(peer) == js.get(peer)
        for path in ("obj", "late/y", "mix/b", "nope"):
            assert ps.get(peer, path) == js.get(peer, path)
    rng = np.random.default_rng(3)
    peers = np.append(rng.integers(0, P, 50), 0)
    sample = [names[int(i)] for i in rng.integers(0, len(names), 50)] + ["missing/x"]
    assert ps.get_bulk(peers, sample) == js.get_bulk(peers, sample)
    slots = np.arange(len(names), dtype=np.int32)
    assert ps.get_bulk(5, slots) == js.get_bulk(5, slots)


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_snapshot_restore_across_respread(monkeypatch, layout):
    """A snapshot taken before a rank respread restores after it, in the
    port as in the reference (rank re-gathers through cv, rank1 through
    the snapshot's own inverse); later writes and convergence still match
    the reference, table for table."""
    monkeypatch.setattr(rk, "RANK_SPAN", 2047)
    monkeypatch.setattr(jrk, "RANK_SPAN", 2047)
    js = JaxSim(4, capacity=256, topology="ring", layout=layout)
    ps = port(4, layout)
    for s in (js, ps):
        seed_puts(s, np.random.default_rng(13), 60)
        for k in range(9):
            s.intern_path(f"m/k{k}")
        for k in range(6):
            s.intern_path(f"z/k{k}")
        s.run_until_converged()
    snaps = [s.snapshot() for s in (js, ps)]
    assert snaps[0]["rank_epoch"] == snaps[1]["rank_epoch"]
    if layout == "rank1":
        for a, b in zip(snaps[0]["rank_inverse"], snaps[1]["rank_inverse"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(snaps[0]["table"], snaps[1]["table"]):
        np.testing.assert_array_equal(a, b)
    epoch0 = ps.rank_index.epoch
    rng = np.random.default_rng(14)
    while ps.rank_index.epoch == epoch0:  # fresh floats split gaps until a respread
        for _ in range(40):
            peer, key, val = int(rng.integers(0, 4)), int(rng.integers(0, 9)), float(rng.random())
            for s in (js, ps):
                s.put(peer, f"m/k{key}", val)
        for s in (js, ps):
            s.run_until_converged()
        assert_same(js, ps)
        assert ps.rank_index.epoch < epoch0 + 50, "respread never fired"
    assert js.rank_index.epoch == ps.rank_index.epoch
    for s, snap in zip((js, ps), snaps):
        s.restore(snap)
    assert_same(js, ps)
    if layout == "rank":  # the ranks are the current index's
        cv = ps.table.cv.numpy()
        present = (cv >> 28) > 0
        np.testing.assert_array_equal(ps.table.rank.numpy()[present],
                                      ps.rank_index.rank_map()[cv & ((1 << 28) - 1)][present])
    for s in (js, ps):
        rg = np.random.default_rng(15)
        for _ in range(30):
            s.put(int(rg.integers(0, 4)), f"z/k{int(rg.integers(0, 6))}",
                  VALS[int(rg.integers(0, len(VALS)))])
        s.run_until_converged()
    assert_same(js, ps)
    assert ps.get(2) == js.get(2)


@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_fast_forward_matches_step(layout, topology):
    """The port's fast_forward(k) against the reference's step(k) and its
    own step(k): table, residual, round stats; reads after the jump."""
    for k in (1, 3, 7, 13):
        js = JaxSim(8, capacity=128, topology=topology, layout=layout)
        a, b = port(8, layout, 128, topology), port(8, layout, 128, topology)
        for s in (js, a, b):
            seed_puts(s, np.random.default_rng(10 + k))
        want = js.step(k)
        assert a.step(k) == want == b.fast_forward(k), (layout, topology, k)
        assert_same(js, b)
        assert_same(js, a)
        assert a.stats["gossip_rounds"] == b.stats["gossip_rounds"] == k
        assert b.stats["windowed_rounds"] == k and a.stats["windowed_rounds"] == 0
        assert b.stats["merged_entries"] == want
        for peer in (0, 7):
            assert b.get(peer, "users/u3/f1") == js.get(peer, "users/u3/f1")


@pytest.mark.parametrize("tracking", ["valid", "invalid"])
def test_fast_forward_packed_tracking(tracking):
    """Packed fast_forward after a converge (tracking valid: new writes dirty
    their stripes) and after a restore (tracking invalid: a blind jump),
    against the reference's step; both run the window join on the CPU."""
    js = JaxSim(16, capacity=512, topology="ring", layout="packed")
    ps = port(16, "packed", 512, use_kernels=True)
    for s in (js, ps):
        seed_puts(s, np.random.default_rng(5))
        s.run_until_converged()
    if tracking == "invalid":
        snap = ps.snapshot()
        ps.restore(snap)
    assert (ps._marks.columns() is not None) is (tracking == "valid")
    for s in (js, ps):
        seed_puts(s, np.random.default_rng(6), 30)
    assert ps._fast_forward_route() == "window"
    for k in (3, 20):
        assert js.step(k) == ps.fast_forward(k)
        assert_same(js, ps)
    assert ps.last_residual == 0 and ps._marks.columns() is not None


def test_fast_forward_frontier_route_matches_step(monkeypatch):
    """The frontier route (packed on the card with valid tracking), driven
    on the CPU by forcing the route: the plain frontier loop with
    max_rounds = k advances exactly k rounds, with step's residual, through
    cutoffs and past the fixed point."""
    for k in (2, 5, 40):
        js = JaxSim(8, capacity=128, topology="ring", layout="packed")
        ps = port(8, "packed", 128, use_kernels=True)
        for s in (js, ps):
            seed_puts(s, np.random.default_rng(50 + k))
        monkeypatch.setattr(ps, "_fast_forward_route", lambda: "frontier")
        assert js.step(k) == ps.fast_forward(k), k
        assert_same(js, ps)
        assert ps.stats["windowed_rounds"] == k
        assert (ps._marks.columns() is not None) is (ps.last_residual == 0)


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_restore_from_reference_rank_snapshot(layout):
    """State carried across: a reference rank or rank1 snapshot, with its
    rank_epoch and rank_inverse, restores into the port's sim (which got
    the same puts, so its interners agree; its RankIndex ranked them in one
    batch, so its ranks may differ and restore re-keys). The port then
    converges to the reference's values."""
    js = JaxSim(P, capacity=512, topology="ring", layout=layout)
    ps = port(P, layout, 512)
    for i, s in enumerate((js, ps)):
        writes(s, 4)
    for seed in (5, 6):  # several insert batches on the reference's side
        writes(js, seed, n_scalar=10, n_bulk=50)
        js.step(1)
    for seed in (5, 6):
        writes(ps, seed, n_scalar=10, n_bulk=50)
    js.step(2)
    snap = js.snapshot()
    ps.restore(snap)
    assert not any(ps._pending) and not ps._pending_bulk
    np.testing.assert_array_equal(cv_of(ps), cv_of(js))
    names = paths_of(js)
    assert ps.get_bulk(np.arange(len(names)) % P, names) == js.get_bulk(
        np.arange(len(names)) % P, names)
    assert ps.run_until_converged() == js.run_until_converged()
    np.testing.assert_array_equal(cv_of(ps), cv_of(js))
    assert ps.get(5) == js.get(5)


def test_fast_forward_route_table(monkeypatch):
    """The port's route beside the reference's (tests/test_fast_forward.py
    route matrix) for every configuration the port has. Mapping: the
    reference's "xla" (off the TPU), "pallas" (full-P stripe window) and
    "halo_window" (peer-tile window) are all the port's "window", since a
    column-owning kernel covers every P; the reference's "frontier" for
    packed with valid tracking stays "frontier" on the card. The reference
    also takes "frontier" for an untracked packed sim whose P no window
    kernel tiles (P = 8 < its halo depth): the port has a window kernel
    for every P and takes "window". "step" stays "step". The card is
    stood in for by the sim's device attribute (the route reads only its
    type)."""
    def ref_route(sim, backend):
        monkeypatch.setattr(jns.jax, "default_backend", lambda: backend)
        try:
            return sim._fast_forward_route()
        finally:
            monkeypatch.undo()

    def port_route(sim, device):
        sim.device = torch.device(device)
        return sim._fast_forward_route()

    def pair(p, topology, layout, capacity=256, tracked=False):
        js = JaxSim(p, capacity=capacity, topology=topology, layout=layout)
        ps = port(p, layout, capacity, topology)
        if tracked:
            for s in (js, ps):  # a reconcile leaves every stripe tracked clean
                s.put(0, "a/x", 1)
                s.reconcile()
        return js, ps

    # (configuration, reference cpu, reference tpu, port cpu, port cuda)
    rows = [
        (pair(8, "ring", "rank1"), "xla", "pallas", "window", "window"),
        (pair(8, "ring", "rank"), "xla", "pallas", "window", "window"),
        (pair(8, "chain", "packed"), "xla", "frontier", "window", "window"),
        (pair(8, "chain", "packed", tracked=True), "xla", "frontier", "window", "frontier"),
        (pair(128, "ring", "packed", 16384), "xla", "halo_window", "window", "window"),
        (pair(128, "ring", "packed", 16384, tracked=True), "xla", "frontier", "window",
         "frontier"),
        (pair(8, "ring", "dense"), "step", "step", "step", "step"),
        (pair(8, "mesh", "rank1"), "step", "step", "step", "step"),
        (pair(8, "star", "packed"), "step", "step", "step", "step"),
    ]
    for (js, ps), ref_cpu, ref_tpu, port_cpu, port_cuda in rows:
        what = (ps.layout, ps.topology.kind, ps.num_peers, ps._marks.columns() is not None)
        assert (ref_route(js, "cpu"), ref_route(js, "tpu")) == (ref_cpu, ref_tpu), what
        assert (port_route(ps, "cpu"), port_route(ps, "cuda")) == (port_cpu, port_cuda), what
    # at P = 8192 rank1 the reference's full-P stripe is past its budget
    # and the halo window takes the jump (#17); the port's window kernel
    # covers that P too
    assert not jpk.window_ring_supported(8192, 1 << 18, 1)
    assert jpk.window_halo_supported(8192, 1 << 18, 1)


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_string_rebalance_needs_no_device_rekey(layout):
    """Strings interned out of order force string-rank rebalances; the
    rank table holds no key bits and stays right, as in the reference."""

    js = JaxSim(4, capacity=256, topology="ring", layout=layout)
    ps = port(4, layout)
    names = [f"s{i:04d}" for i in range(120)]
    random.Random(7).shuffle(names)
    word = "m"
    for i, name in enumerate(names):
        word = word + ("a" if i % 2 else "z")  # adversarial: forces rebalances
        for s in (js, ps):
            s.put(i % 4, f"w/p{i % 37}", name)
            s.put((i + 1) % 4, f"v/p{i % 11}", word)
        if i % 40 == 0:
            for s in (js, ps):
                s.run_until_converged()
            assert_same(js, ps)
    for s in (js, ps):
        s.run_until_converged()
    assert js.host.values.epoch == ps.host.values.epoch > 0
    assert_same(js, ps)
    assert ps.get(2) == js.get(2)


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_reconcile_weak_topology_rank(layout):
    rng = np.random.default_rng(4)
    adj = rng.random((6, 6)) < 0.25
    np.fill_diagonal(adj, False)
    js = JaxSim(6, capacity=128, topology=jax_topo.from_adjacency(adj), layout=layout)
    ps = port(6, layout, 128, topo.from_adjacency(adj))
    for s in (js, ps):
        seed_puts(s, np.random.default_rng(5), 60)
        s.reconcile()
    assert_same(js, ps)
    assert ps.get(3) == js.get(3)


def test_rank_layouts_shape_and_checks():
    assert port(4, "rank").table._fields == ("rank", "cv")
    assert port(4, "rank1").table._fields == ("rank",)
    with pytest.raises(ValueError, match="reference mode"):
        PeerNetworkSim(4, layout="rank1", mode="lww", device="cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        PeerNetworkSim(4, layout="rank0", device="cpu")


@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_on_callbacks_rank(layout):
    seen = {"jax": [], "port": []}
    sims = {"jax": JaxSim(6, capacity=64, topology="chain", layout=layout),
            "port": port(6, layout, 64, "chain")}
    for name, s in sims.items():
        log = seen[name]
        s.on(5, "w", lambda v, log=log: log.append(("w", v)))
        s.put(0, "w/a", 5)
        s.run_until_converged()
        s.put(1, "w/a", 2)  # loses in reference mode: no callback
        s.put(2, "w/b", "x")
        s.fast_forward(5)
        s.reconcile()
    assert seen["jax"] == seen["port"]
    assert seen["port"][-1] == ("w", {"a": 5, "b": "x"})
