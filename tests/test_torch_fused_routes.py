"""The card's fused routes, forced on CPU sims, against the reference's
sims (``use_pallas=True``) op by op.

A sim takes its fused routes where ``PeerNetworkSim._card_routes`` says
so, which is on a CUDA device: STRIPE_FUSE = 8 rounds a frontier step
(dense in reference, lww and lean mode; packed, rank, rank1), HALO_FUSE =
8 rounds an exchange on a ``use_shard_map`` mesh whose shards are too
small for a window, m-round windows an exchange where they are not, a
tracked packed ``fast_forward`` on the frontier, and an uncapped converge
of the packed family as one column pass. Here that method is
patched to say yes on the CPU, where the kernels' plain versions run the
same schedules. Random op sequences (puts of every value kind, put_bulk,
remove, step, fast_forward, run_until_converged with and without a
cutoff, converged(), reconcile, get) go into both sims; after every op the
tables, the return value and ``last_residual`` must equal the
reference's. Tolerance: exact."""

import jax
import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.models import netsim as port_netsim
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.ops import ring_kernel
from bullet_tpu_torch.parallel.shardmap_gossip import HALO_FUSE

torch.set_num_threads(2)

OPS_PER_SEED = 20
SEEDS = (0, 1)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(PeerNetworkSim, "_card_routes", lambda self: True)


def spy(monkeypatch, module, name):
    """The keyword arguments of every call of ``module.name`` from now on."""
    calls, real = [], getattr(module, name)

    def record(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, record)
    return calls


def assert_same(js, ps, what):
    got = table_to_numpy(ps.table)
    assert len(got) == len(js.table), what
    for a, b in zip(got, js.table):
        np.testing.assert_array_equal(a, np.asarray(b), what)
    assert ps.last_residual == js.last_residual, what


def value(rng, i):
    """A value of every kind the sims store: numbers with ties, strings,
    bools, null, an array, an object."""
    kind = int(rng.integers(8))
    if kind < 3:
        return int(rng.integers(-6, 6)) if kind else float(rng.integers(-8, 8)) / 4
    if kind == 3:
        return "s" + "abc"[int(rng.integers(3))] * int(rng.integers(1, 4))
    if kind == 4:
        return bool(rng.integers(2))
    if kind == 5:
        return None
    if kind == 6:
        return [int(rng.integers(3)), "x"]
    return {"a": int(rng.integers(9)), "b": {"c": f"v{i % 3}"}}


def random_op(rng, p, i):
    """One op as (name, args), drawn once and given to both sims."""
    r = rng.random()
    key = f"k{int(rng.integers(24))}"
    if i == 0 or r < 0.3:
        return "put", (int(rng.integers(p)), f"t/{key}", value(rng, i))
    if r < 0.42:
        k = int(rng.integers(8, 60))
        peers = rng.integers(0, p, k)
        paths = [f"b/{int(x)}" for x in rng.integers(0, 90, k)]
        if rng.random() < 0.5:
            return "put_bulk", (peers, paths, rng.integers(-50, 50, k))
        vals = [value(rng, j) for j in range(k)]
        return "put_bulk", (peers, paths, [j if isinstance(v, dict) else v
                                           for j, v in enumerate(vals)])
    if r < 0.47:
        return "remove", (int(rng.integers(p)), f"t/{key}")
    if r < 0.57:
        return "step", (int(rng.integers(0, 4)),)
    if r < 0.67:
        return "fast_forward", (int(rng.integers(1, 2 * p)),)
    if r < 0.75:
        return "run_until_converged", ()
    if r < 0.82:
        return "run_until_converged", (int(rng.integers(1, p)),)
    if r < 0.87:
        return "converged", ()
    if r < 0.92:
        return "reconcile", ()
    return "get", (int(rng.integers(p)), "" if rng.random() < 0.3 else "t")


def fuzz(make, p, seed, check_route=None):
    """``OPS_PER_SEED`` random ops into a reference sim and a port sim from
    ``make()``; every op's result, the tables and last_residual agree."""
    rng = np.random.default_rng(seed)
    js, ps = make()
    for i in range(OPS_PER_SEED):
        name, args = random_op(rng, p, i)
        want = getattr(js, name)(*args)
        got = getattr(ps, name)(*args)
        what = f"seed {seed} op {i}: {name}{args if name != 'put_bulk' else ''}"
        assert got == want, what
        assert_same(js, ps, what)
    if check_route:
        check_route(ps)
    # end at the fixed point on the fused route, whatever the ops left
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps, f"seed {seed}: the last converge")


UNSHARDED = [
    ("dense", "reference", False),
    ("dense", "lww", False),
    ("dense", "reference", True),
    ("packed", "reference", False),
    ("rank", "reference", False),
    ("rank1", "reference", False),
]


@pytest.mark.parametrize("topology", ["ring", "chain"])
@pytest.mark.parametrize("layout,mode,lean", UNSHARDED)
def test_stripe_fuse_unsharded(fused, monkeypatch, layout, mode, lean, topology):
    """STRIPE_FUSE rounds a frontier step, and (packed) the tracked
    fast_forward on the frontier; the packed family's uncapped converges
    take the column pass, and a converge capped at the diameter, cut off
    there, keeps the fused frontier loop."""
    calls = (spy(monkeypatch, ring_kernel, "gossip_frontier_dense") if layout == "dense"
             else spy(monkeypatch, pk, "gossip_frontier_packed"))
    passes = spy(monkeypatch, pk, "gossip_columns_packed")
    p = 24
    kw = dict(capacity=128, topology=topology, mode=mode, lean_gossip=lean, layout=layout)

    def make():
        return (JaxSim(p, use_pallas=True, **kw),
                PeerNetworkSim(p, device="cpu", use_kernels=True, **kw))

    def route(ps):
        want = "dense-frontier" if layout == "dense" else "packed-frontier-local"
        assert ps._convergence_strategy()[0] == want

    for seed in SEEDS:
        fuzz(make, p, seed, route)
    js, ps = make()
    for s in (js, ps):
        s.put(0, "t/k", 1)
    cap = ps.topology.diameter
    assert ps.run_until_converged(cap) == js.run_until_converged(cap) == cap
    assert_same(js, ps, "a converge cut off at the diameter")
    assert calls and all(kw["fuse"] == pk.STRIPE_FUSE for kw in calls)
    assert bool(passes) is (layout != "dense")


def test_forced_routes_take_the_fuse(fused, monkeypatch):
    """The patched method really picks the card's schedules: an uncapped
    converge takes the column pass, a converge capped at the diameter the
    frontier loop with fuse = STRIPE_FUSE, and a tracked packed
    fast_forward the frontier route, fused too."""
    seen = spy(monkeypatch, pk, "gossip_frontier_packed")
    passes = spy(monkeypatch, pk, "gossip_columns_packed")
    sim = PeerNetworkSim(24, capacity=128, layout="packed", device="cpu", use_kernels=True)
    sim.put(3, "a", 1)
    sim.run_until_converged()
    assert len(passes) == 1 and not seen
    # two antipodal holders settle in 6 rounds, inside the cap
    sim.put(5, "a", 3)
    sim.put(17, "a", 3)
    assert sim.run_until_converged(max_rounds=sim.topology.diameter) == 7
    sim.put(9, "a", 4)
    sim.step(0)
    assert sim._fast_forward_route() == "frontier"
    sim.fast_forward(5)
    assert [kw["fuse"] for kw in seen] == [pk.STRIPE_FUSE, pk.STRIPE_FUSE]
    assert len(passes) == 1


needs_devices = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")


@needs_devices
@pytest.mark.parametrize("layout,rows,window", [
    ("packed", 8, 0),  # shards too small for a window: HALO_FUSE
    ("rank", 8, 8),
    ("rank1", 16, 15),
    ("packed", 16, 8),
    ("rank1", 8, 0),
])
def test_mesh_fuses(fused, monkeypatch, layout, rows, window):
    """The packed family on an 8-way shard_map mesh: HALO_FUSE rounds an
    exchange (window 0), or m-round windows (15 is the depth the
    reference's window_frontier_params gives 16-row shards; 8 is forced)."""
    if window and window != pk.window_frontier_depth(rows, 128):
        monkeypatch.setattr(pk, "window_frontier_depth", lambda b, n: window)
    assert pk.window_frontier_depth(rows, 128) == window
    calls = spy(monkeypatch, port_netsim, "gossip_frontier_shardmap_packed")
    p = 8 * rows
    kw = dict(capacity=128, topology="ring" if rows == 16 else "chain", layout=layout,
              mesh_devices=8, use_shard_map=True)

    def make():
        return (JaxSim(p, use_pallas=True, **kw),
                PeerNetworkSim(p, device="cpu", use_kernels=True, **kw))

    def route(ps):
        assert ps._convergence_strategy()[0] == "packed-frontier-spmd"

    for seed in SEEDS:
        fuzz(make, p, 10 + seed, route)
    want = (1, window) if window else (HALO_FUSE, 0)
    assert calls and all((kw["fuse"], kw["window_fuse"]) == want for kw in calls)


@needs_devices
@pytest.mark.parametrize("mode,lean,topology", [
    ("reference", False, "ring"), ("lww", False, "chain"), ("reference", True, "ring"),
])
def test_dense_mesh_halo_fuse(fused, monkeypatch, mode, lean, topology):
    """The dense frontier on an 8-way shard_map mesh at HALO_FUSE rounds
    an exchange."""
    calls = spy(monkeypatch, port_netsim, "gossip_frontier_shardmap_dense")
    p = 64
    kw = dict(capacity=128, topology=topology, mode=mode, lean_gossip=lean,
              mesh_devices=8, use_shard_map=True)

    def make():
        return (JaxSim(p, use_pallas=True, **kw),
                PeerNetworkSim(p, device="cpu", use_kernels=True, **kw))

    def route(ps):
        assert ps._convergence_strategy()[0] == "dense-frontier-spmd"

    for seed in SEEDS:
        fuzz(make, p, 20 + seed, route)
    assert calls and all(kw["fuse"] == HALO_FUSE for kw in calls)
