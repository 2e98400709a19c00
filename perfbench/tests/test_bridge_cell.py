"""A bridge deployment's cell at a tiny size: 6 full-mesh clusters of 5
joined through 2 bridge peers (32 peers x 4,096 slots), the bridge
configuration ``packed-bridge-1024x1M`` cut to that size, added to a copy
of the benchmark by files and entries alone, under the tiny zipf-scatter
mix.
With the card's routes forced on the CPU (``PeerNetworkSim._card_routes``
patched) every converge runs the graph pass (``gossip_graph_packed``, its
plain version here) and no plain round loop: the run comes out correct,
and with a slot of the pass's neighbour list skipped (the gateways' pull
from the first bridge peer, and that bridge's pull from a gateway) it
comes out not correct, as it does where every converge of the window
stops after two rounds, one short of what a write at a cluster member
needs to reach the members of every other cluster. Without the forced
routes the plain round loop runs and the run is correct too.

On the card (``-m card``) the cell's own configuration (204 clusters of 5
and 4 bridge peers: 1,024 peers x 2^20 slots) takes three
batches of the zipf-scatter mix; after each ``step(0)`` the batch's dirty
columns are copied, the program converges, and the plain reference
(``reference/graph_rounds.py``) runs the same rounds on the copy: the
columns, the rounds and the last count must agree."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.ops import packed as pk
from perfbench import harness
from perfbench.generator import Traffic
from perfbench.reference import graph_rounds
from perfbench.ycsb import key_names
from test_perfbench_harness import ROOT, run, tiny_root  # noqa: F401 (a fixture)

SPEC = {"kind": "bridge", "clusters": 6, "cluster_size": 5, "bridge_peers": 2}
BRIDGE = "packed-bridge-1024x1M"
CELL = "packed-bridge.tiny-zipf-scatter"
# the slot the fault skips: the gateways' first bridge peer (their slots 0-3
# are their cluster's other members)
SKIPPED_SLOT = 4


@pytest.fixture(scope="module")
def bridge_root(tiny_root):
    """The tiny root with the tiny bridge configuration and its cell, which
    reports what the packed ring's zipf-scatter cell reports."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if not any(w["name"] == CELL for w in bench["workloads"]):
        base = next(c for c in bench["configs"] if c["name"] == BRIDGE)
        config = json.loads((tiny_root / base["file"]).read_text())
        config.update(name="packed-bridge-tiny", num_peers=32, capacity=4096, records=372,
                      interned_paths=4093, topology=SPEC)
        path = "perfbench/configs/packed-bridge-tiny.json"
        (tiny_root / path).write_text(json.dumps(config))
        bench["configs"].append({**base, "name": "packed-bridge-tiny", "file": path,
                                 "reduced": ["num_peers", "capacity", "records", "topology"],
                                 "why": "CPU test size"})
        bench["workloads"].append({"name": CELL, "config": "packed-bridge-tiny",
                                   "traffic": "tiny-zipf-scatter", "chips": 1, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "packed-bridge.zipf-scatter" in m.get("workloads", []):
                m["workloads"].append(CELL)
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


@pytest.fixture
def routes(monkeypatch):
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


def test_cell_takes_the_graph_pass(bridge_root, routes):
    res = run(bridge_root, CELL)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"converge_ms", "setup_s"}
    assert routes["graph"] > 1 and routes["plain"] == 0


def test_cell_on_the_plain_loop(bridge_root):
    res = run(bridge_root, CELL)
    assert res["correct"] and res["failed"] == 0, res["checks"]


def test_skipped_slot_fails(bridge_root, routes, monkeypatch):
    """The pass's neighbour list without one slot: the first bridge peer's
    writes reach no gateway, and the run is not correct."""
    real = pk.GraphPlan

    def skipping(neighbors):
        nb = np.array(neighbors, copy=True)
        nb[:, SKIPPED_SLOT] = -1
        return real(nb)

    monkeypatch.setattr(pk, "GraphPlan", skipping)
    res = run(bridge_root, CELL)
    assert not res["correct"], res["checks"]
    assert res["checks"]["replicas_differing"]["value"] > 0
    assert routes["graph"] > 1 and routes["plain"] == 0


def test_two_rounds_fail(bridge_root, routes, monkeypatch):
    """Every converge of the window stopped after two rounds: the writes at
    a cluster's members reach no other cluster's members (member, gateway,
    bridge, gateway, member takes three rounds), and the run is not
    correct."""
    real = PeerNetworkSim.run_until_converged

    def two_rounds(self, max_rounds=None):
        loaded = self.stats["steps"] >= 2
        return real(self, 2 if loaded else max_rounds)

    monkeypatch.setattr(PeerNetworkSim, "run_until_converged", two_rounds)
    res = run(bridge_root, CELL)
    assert not res["correct"], res["checks"]
    assert res["checks"]["replicas_differing"]["value"] > 0
    assert routes["graph"] > 1 and routes["plain"] == 0


@pytest.mark.card
def test_graph_rounds_against_the_program_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.Cell(ROOT, "packed-bridge.zipf-scatter")
    config = spec.config
    p, fields, n_rec = config["num_peers"], config["fields_per_record"], config["records"]
    sim = harness.build_sim(config, "cuda")
    slots = sim.host.intern_batch([f"{config['table']}/{k}/field{j}" for k in key_names(n_rec)
                                   for j in range(fields)]).astype(np.int32)
    sim.put_bulk(config["load_peer"], slots, np.zeros(len(slots), dtype=np.int64))
    sim.step(0)
    sim.run_until_converged()
    traffic = Traffic(spec.mix, n_rec, fields, p, seed=3_141_592_653)
    cap = max(2 * sim.topology.diameter + 2, 4)
    for t in (1, 2, 3):
        it = traffic.iteration(t)
        sim.put_bulk(it.peers, slots[it.leaves], it.values)
        sim.step(0)
        cols = torch.from_numpy(np.unique(slots[it.leaves]).astype(np.int64)).cuda()
        copy = [f.index_select(1, cols) for f in sim.table]
        rounds = sim.run_until_converged()
        want, want_rounds, want_count = graph_rounds.rounds(sim.topology.neighbors, copy, cap)
        same = all(torch.equal(f.index_select(1, cols), w) for f, w in zip(sim.table, want))
        print(f"batch {t}: {cols.numel()} dirty columns, program {rounds} rounds residual "
              f"{sim.last_residual}, reference {want_rounds} rounds last count {want_count}, "
              f"columns bit for bit {same}")
        assert same and (rounds, sim.last_residual) == (want_rounds, want_count)
