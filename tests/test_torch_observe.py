"""The port's step observer and profiler trace (``utils/observe.py``).

``StepObserver`` on a port sim (device="cpu") records the same events as
the reference's on a reference sim (JAX, CPU) given the same writes:
kinds, ticks, residuals, converge round counts and counters, for dense,
packed and rank1 sims, ring and chain. ``profile_trace`` writes a Chrome
trace of the block into its directory (CPU activity here), also when the
block raises, with the program's spans of the block in it. Tolerance:
exact."""

import glob
import json

import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.utils.observe import StepObserver as JaxObserver
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.utils.observe import StepObserver, profile_trace
from test_torch_netsim import writes

torch.set_num_threads(2)


def drive(sim, seed):
    """Steps, converges and late writes, from one seed."""
    rng = np.random.default_rng(seed)
    writes(sim, seed, n_scalar=20, n_bulk=60)
    sim.step(1)
    sim.step(int(rng.integers(2, 5)))
    sim.run_until_converged()
    sim.put(int(rng.integers(16)), "late/x", int(rng.integers(100)))
    sim.step(0)
    sim.run_until_converged(3)
    sim.run_until_converged()


def shape(event):
    return {k: v for k, v in event.items() if k != "wall_s"}


@pytest.mark.parametrize("layout,topology", [("dense", "ring"), ("packed", "chain"),
                                             ("rank1", "ring")])
def test_observer_history_matches_reference(layout, topology):
    kw = dict(capacity=256, topology=topology, layout=layout)
    js, ps = JaxSim(16, **kw), PeerNetworkSim(16, device="cpu", **kw)
    jo, po = JaxObserver.attach(js), StepObserver.attach(ps)
    seen = []
    po.on_step(seen.append).on_step(lambda e: 1 / 0)  # a failing listener is isolated
    for s, seed in ((js, 1), (ps, 1)):
        drive(s, seed)
    assert [e["kind"] for e in po.history] == [e["kind"] for e in jo.history] == [
        "step", "step", "converge", "step", "converge", "converge"]
    for got, want in zip(po.history, jo.history):
        assert shape(got) == shape(want)
        assert got["wall_s"] > 0
    assert seen == po.history
    summary, ref = po.summary(), jo.summary()
    assert summary["total_wall_s"] > 0
    del summary["total_wall_s"], ref["total_wall_s"]
    assert summary == ref and summary["steps"] == 3 and summary["events"] == 6
    po.detach()
    ps.step()
    assert len(po.history) == 6 and ps.step.__self__ is ps


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    sim = PeerNetworkSim(8, capacity=128, layout="packed", device="cpu")
    assert sim.put(0, "a", 1)
    with profile_trace(str(tmp_path / "t")):
        sim.run_until_converged()
        assert sim.get(3, "a") == 1
    files = glob.glob(str(tmp_path / "t" / "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    # the program's spans, on a track of their own, on the operators' clock
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert {"converge", "loop", "get", "get.gather"} <= set(spans)
    get, gather = spans["get"], spans["get.gather"]
    assert get["ph"] == "X" and get["tid"] != get["pid"]
    assert get["ts"] <= gather["ts"] and gather["ts"] + gather["dur"] <= get["ts"] + get["dur"]
    # the gather's own operator lies inside its span
    assert any(e.get("name") == "aten::index" and gather["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= gather["ts"] + gather["dur"] for e in events)
    with pytest.raises(ZeroDivisionError):
        with profile_trace(str(tmp_path / "t")):
            sim.step(1)
            1 / 0
    assert len(glob.glob(str(tmp_path / "t" / "trace_*.json"))) == 2
