"""Checkpoints across the two packages: a checkpoint that a reference
PeerNetworkSim (JAX, CPU) saves loads in the port (device="cpu"), and one
the port saves loads in the reference, on the dense (reference and lww),
packed, rank and rank1 layouts, unsharded and on a 4-shard mesh. The two
packages write the same files (``state.npz`` arrays, ``meta.json``); a
load gives the table the reference's own load gives (through
``convert.py``) and the same reads, and both loaded sims take the same
next batch to the same fixed point. Also: the flush of queued ops before a
save, a string-rank re-key pending at save time, the rank1 inverse across
forced rank respreads, and the refusals (orbax, a foreign file, no card).
Tolerance: exact.

The reference's ``test_checkpoint_orbax_backend`` has no mirror: orbax is
a JAX library, so the port saves and loads ``backend="npz"`` only and
refuses the other (``test_orbax_is_refused``)."""

import json

import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops import rank as jrk
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.models import checkpoint
from bullet_tpu_torch.ops import rank as rk
from bullet_tpu_torch.parallel.mesh import ShardedTable
from bullet_tpu_torch.convert import table_to_numpy
from test_torch_netsim import P, paths_of, writes

torch.set_num_threads(2)

CELLS = [("dense", "reference"), ("dense", "lww"), ("packed", "reference"),
         ("rank", "reference"), ("rank1", "reference")]


def pair(layout, mode="reference", mesh=None, capacity=256, topology="ring"):
    """A reference sim and a port sim of one configuration."""
    kw = dict(capacity=capacity, topology=topology, mode=mode, layout=layout,
              mesh_devices=mesh)
    return JaxSim(P, **kw), PeerNetworkSim(P, device="cpu", **kw)


def assert_same(jax_sim, port_sim):
    """The port's table (sharded or not) equals the reference's, bit for bit."""
    got, want = table_to_numpy(port_sim.table), [np.asarray(f) for f in jax_sim.table]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def load_port(directory, mesh=None):
    return PeerNetworkSim.load_checkpoint(directory, mesh, device="cpu")


def same_files(dj, dp):
    """The two packages' checkpoints of twin sims hold the same arrays and
    the same meta.json (the counters' keys, not their values)."""
    with np.load(dj / "state.npz") as a, np.load(dp / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], name)
    mj, mp = (json.loads((d / "meta.json").read_text()) for d in (dj, dp))
    assert sorted(mj) == sorted(mp)
    assert sorted(mj.pop("stats")) == sorted(mp.pop("stats"))
    assert mj == mp


def same_reads(a, b, names):
    rng = np.random.default_rng(5)
    for peer in (0, 7, P - 1):
        assert a.get(peer) == b.get(peer)
        for i in rng.integers(0, len(names), 12):
            assert a.get(peer, names[int(i)]) == b.get(peer, names[int(i)])


@pytest.mark.parametrize("mesh", [None, 4], ids=["one", "mesh4"])
@pytest.mark.parametrize("layout,mode", CELLS)
def test_checkpoint_crosses_packages(tmp_path, layout, mode, mesh):
    js, ps = pair(layout, mode, mesh)
    for s in (js, ps):
        writes(s, 1)
        s.step(1)
        writes(s, 2, n_bulk=120)  # queued at the save: the save applies them
    dj, dp = tmp_path / "jax", tmp_path / "port"
    js.save_checkpoint(str(dj))
    ps.save_checkpoint(str(dp))
    assert not any(ps._pending) and not ps._pending_bulk
    assert_same(js, ps)
    same_files(dj, dp)

    pj = load_port(dj, mesh)  # the port loads the reference's checkpoint
    jp = JaxSim.load_checkpoint(str(dp), mesh)  # and the reference the port's
    jj = JaxSim.load_checkpoint(str(dj), mesh)  # the reference's own load
    assert isinstance(pj.table, ShardedTable) is (mesh is not None)
    assert (pj.layout, pj.mode, pj.tick, pj.capacity) == (jj.layout, jj.mode, jj.tick, jj.capacity)
    assert pj.topology.kind == jj.topology.kind == "ring"
    np.testing.assert_array_equal(pj._clock_snapshot(), jj._clock_snapshot())
    assert_same(jj, pj)
    assert_same(jp, pj)
    if layout in ("dense", "packed"):
        assert_same(js, pj)  # no ranks to respread: the saved table itself
    names = paths_of(ps)
    assert paths_of(pj) == paths_of(jp) == names
    same_reads(js, pj, names)
    same_reads(jp, pj, names)

    for s in (pj, jp):
        writes(s, 3)
        s.run_until_converged()
    assert_same(jp, pj)
    assert pj.tables_equal() and jp.tables_equal()
    same_reads(jp, pj, paths_of(pj))


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_pending_rekey_crosses_packages(tmp_path, layout):
    """A string-rank rebalance pending at the save: both packages write the
    re-keyed table, and the string order holds after either load."""
    js, ps = pair(layout, capacity=512, topology="chain")
    for s in (js, ps):
        for i in range(60):
            s.put(0, f"s/k{i:03d}", f"v{i:05d}")
        s.run_until_converged()
        word = "v00007"
        for i in range(64):  # adversarial inserts exhaust the rank gaps
            word += "a" if i % 2 else "z"
            s.put(1, f"s/m{i:03d}", word)
    assert ps.host.needs_rekey and ps.host.values.epoch == js.host.values.epoch > 0
    js.save_checkpoint(str(tmp_path / "j"))
    ps.save_checkpoint(str(tmp_path / "p"))
    same_files(tmp_path / "j", tmp_path / "p")
    pj, jp = load_port(tmp_path / "j"), JaxSim.load_checkpoint(str(tmp_path / "p"))
    for s in (pj, jp):
        s.run_until_converged()
        assert s.tables_equal()
        assert s.equals(0, "s", "v00003") == ["s/k003"]
        assert s.equals(P - 1, "s", "v00007z") == ["s/m000"]
    assert_same(jp, pj)
    assert pj.get(3, "s") == jp.get(3, "s") and len(pj.get(3, "s")) == 124


@pytest.mark.parametrize("mesh", [None, 4], ids=["one", "mesh4"])
@pytest.mark.parametrize("layout", ["rank", "rank1"])
def test_rank_inverse_across_respreads(tmp_path, monkeypatch, layout, mesh):
    """With the rank space shrunk, the saved ranks come from several
    respreads and the load's one-batch replay spreads them otherwise: the
    load re-gathers them (rank through cv, rank1 through the checkpoint's
    inverse), in the port as in the reference."""
    monkeypatch.setattr(rk, "RANK_SPAN", 2047)
    monkeypatch.setattr(jrk, "RANK_SPAN", 2047)
    js, ps = pair(layout, mesh=mesh)
    for s in (js, ps):
        r = np.random.default_rng(9)
        for batch in range(4):
            k = 60
            s.put_bulk(r.integers(0, P, k), [f"r/{batch}/{i}" for i in range(k)],
                       [f"w{int(v):04d}" for v in r.integers(0, 3000, k)])
            s.step(1)
        s.put(5, "r/after", "w1500a")  # ranked between two, after the respreads
        s.step(1)
    assert ps.rank_index.epoch == js.rank_index.epoch > 0
    js.save_checkpoint(str(tmp_path / "j"))
    ps.save_checkpoint(str(tmp_path / "p"))
    same_files(tmp_path / "j", tmp_path / "p")
    with np.load(tmp_path / "p" / "state.npz") as z:
        assert ("rank_inv_ranks" in z.files) is (layout == "rank1")
    pj, jp = load_port(tmp_path / "p", mesh), JaxSim.load_checkpoint(str(tmp_path / "j"), mesh)
    assert_same(jp, pj)
    # the replay ranked the values otherwise: the load had to re-gather
    assert not np.array_equal(pj.rank_index.rank_map(), ps.rank_index.rank_map())
    names = paths_of(ps)
    same_reads(ps, pj, names)
    same_reads(js, jp, names)
    for s in (pj, jp):
        s.put(3, "r/late", "w0000a")
        s.run_until_converged()
    assert_same(jp, pj)
    assert pj.get(P - 1, "r/late") == "w0000a"


def test_orbax_is_refused(tmp_path):
    sim = PeerNetworkSim(4, capacity=32, device="cpu")
    sim.put(0, "o/x", 7)
    with pytest.raises(ValueError, match="JAX-only"):
        sim.save_checkpoint(str(tmp_path / "o"), backend="orbax")
    sim.save_checkpoint(str(tmp_path / "n"))
    meta = json.loads((tmp_path / "n" / "meta.json").read_text())
    assert (meta["format"], meta["version"], meta["backend"]) == (
        "bullet-tpu-checkpoint", 1, "npz")
    meta["backend"] = "orbax"
    (tmp_path / "n" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="JAX-only"):
        load_port(tmp_path / "n")
    (tmp_path / "n" / "meta.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a bullet-tpu checkpoint"):
        load_port(tmp_path / "n")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without a card")
def test_load_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    sim = PeerNetworkSim(4, capacity=32, device="cpu")
    sim.put(0, "x", 1)
    sim.save_checkpoint(str(tmp_path / "c"))
    with pytest.raises((AssertionError, RuntimeError)):
        checkpoint.load_checkpoint(str(tmp_path / "c"))
    with pytest.raises((AssertionError, RuntimeError)):
        PeerNetworkSim.load_checkpoint(str(tmp_path / "c"))
    assert load_port(tmp_path / "c").get(3, "x") is None  # saved before a round
    assert load_port(tmp_path / "c").get(0, "x") == 1
