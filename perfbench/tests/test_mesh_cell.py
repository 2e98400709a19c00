"""The harness on a sharded configuration, on the CPU: a tiny mesh cell
(16 peers x 2^10 slots in two 8-row shards, the ``zipf-scatter`` mix cut
to 512 updates) in one process over two virtual shards, and in two
processes joined by gloo through ``run.py``'s launcher (``cpu_run.py``).
The check over shards comes out 0 on sound runs and above 0 on the control
and on each planted fault; a worker that dies or stalls fails the run
within its timeout."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from test_perfbench_harness import FAULTS, run, tiny_root  # noqa: F401 (a fixture)

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
CELL = "packed-mesh.tiny-zipf-scatter"
SEED = 2_147_483_713


def add_mesh_cell(root: Path) -> None:
    """A tiny sharded configuration and its cell, by a new file and entries,
    reporting what ``packed-mesh.zipf-scatter`` reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    full = next(w for w in bench["workloads"] if w["name"] == "packed-mesh.zipf-scatter")
    entry = next(c for c in bench["configs"] if c["name"] == full["config"])
    config = json.loads((root / entry["file"]).read_text())
    config.update(name="packed-mesh-tiny", num_peers=16, capacity=1024, records=93,
                  interned_paths=1024, shards=2)
    (root / "perfbench" / "configs" / "packed-mesh-tiny.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "packed-mesh-tiny", "source": entry["source"],
                             "file": "perfbench/configs/packed-mesh-tiny.json",
                             "reduced": ["num_peers", "capacity", "records", "shards"],
                             "why": "CPU test size"})
    bench["workloads"].append({"name": CELL, "config": "packed-mesh-tiny",
                               "traffic": "tiny-zipf-scatter", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if full["name"] in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(HERE / "cpu_run.py", root / "perfbench" / "cpu_run.py")


@pytest.fixture(scope="module")
def mesh_root(tiny_root, tmp_path_factory) -> Path:  # noqa: F811 (the fixture)
    root = tmp_path_factory.mktemp("mesh") / "bench"
    shutil.copytree(tiny_root, root)
    add_mesh_cell(root)
    return root


def tiny_config(root: Path) -> dict:
    return json.loads((root / "perfbench" / "configs" / "packed-mesh-tiny.json").read_text())


def test_mesh_sim_takes_the_sharded_frontier(mesh_root):
    sim = harness.build_sim(tiny_config(mesh_root), "cpu")
    assert type(sim.table).__name__ == "ShardedTable" and len(sim.mesh) == 2
    assert sim._convergence_strategy()[0] == "packed-frontier-spmd"


def test_check_over_one_process_mesh(mesh_root):
    """0 on a converged mesh sim; 1 with one entry planted in a shard other
    than the one that holds replica 0."""
    config = tiny_config(mesh_root)
    sim = harness.build_sim(config, "cpu")
    team = harness.Team(sim)
    assert not team.distributed
    rng = np.random.default_rng(7)
    slots = sim.host.intern_batch([f"k/{i}" for i in range(900)]).astype(np.int32)
    sim.put_bulk(rng.integers(0, 16, 400).astype(np.int32), slots[rng.integers(0, 900, 400)],
                 rng.integers(0, 50, 400))
    sim.step(0)
    sim.run_until_converged()
    assert sim.last_residual == 0 and harness.replicas_differing(sim, team) == 0
    sim.table.shards[1][2][3, int(slots[5])] += 1
    assert harness.replicas_differing(sim, team) == 1
    sim.table.shards[0][0][0, int(slots[9])] += 1  # replica 0 itself: every other row differs
    assert harness.replicas_differing(sim, team) == 15


def test_one_process_mesh_run_matches_reference(mesh_root):
    res = run(mesh_root, CELL, seed=SEED)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"converge_ms", "setup_s"}
    traced = run(mesh_root, CELL, seed=SEED, trace=True)
    assert traced["correct"] and set(traced["metrics"]) == {"put_ms", "apply_ms"}


def test_one_process_mesh_control_fails(mesh_root):
    res = run(mesh_root, CELL, seed=SEED, control="cutoff")
    assert not res["correct"]
    assert res["checks"]["replicas_differing"]["value"] > 0


def _exchange_left_out(monkeypatch, sim_cls):
    """After the load, every slab a shard receives holds absent entries
    alone: no write crosses a shard boundary."""
    from bullet_tpu_torch.parallel import shardmap_gossip as sg

    armed = []
    converge, transfer = sim_cls.run_until_converged, sg.transfer

    def run_until_converged(self, max_rounds=None):
        if self.stats["steps"] >= 2:
            armed.append(1)
        return converge(self, max_rounds)

    def blank(mesh, jobs, nf, n, copy=True):
        got = transfer(mesh, jobs, nf, n, copy)
        return {k: [torch.zeros_like(b) for b in v] for k, v in got.items()} if armed else got

    monkeypatch.setattr(sim_cls, "run_until_converged", run_until_converged)
    monkeypatch.setattr(sg, "transfer", blank)


def _entry_corrupted_in_shard(monkeypatch, sim_cls):
    """After each window converge, one entry of the second shard altered."""
    converge = sim_cls.run_until_converged

    def run_until_converged(self, max_rounds=None):
        rounds = converge(self, max_rounds)
        if self.stats["steps"] >= 2:
            self.table.shards[1][0][3, 7] += 1
        return rounds

    monkeypatch.setattr(sim_cls, "run_until_converged", run_until_converged)


MESH_FAULTS = {
    "state_unchanged": FAULTS["state_unchanged"],
    "half_batch": FAULTS["half_batch"],
    "first_op_kept": FAULTS["first_op_kept"],
    "exchange_left_out": _exchange_left_out,
    "entry_corrupted": _entry_corrupted_in_shard,
}


@pytest.mark.parametrize("fault", sorted(MESH_FAULTS))
def test_mesh_fault_fails(mesh_root, monkeypatch, fault):
    """A mesh run with the timed path broken underneath: not correct."""
    from bullet_tpu_torch import PeerNetworkSim

    MESH_FAULTS[fault](monkeypatch, PeerNetworkSim)
    res = run(mesh_root, CELL, seed=SEED)
    assert not res["correct"], res["checks"]


def launch(root: Path, *extra, timeout=240):
    """``cpu_run.py`` on the tiny mesh cell, the port taken from this
    repository: (exit code, stdout, stderr, seconds)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(root / "perfbench" / "cpu_run.py"), "--workload", CELL, "--seed",
         str(SEED), "--seconds", "0.5", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=root, timeout=timeout, env=env)
    return out.returncode, out.stdout, out.stderr, time.monotonic() - t


def test_two_gloo_processes_match_reference(mesh_root):
    """Two processes, one shard each, through the launcher: the same checks
    as the one-process mesh, each 0; rank 0 alone prints, its result the
    last line of standard output, its checks the last lines of standard
    error."""
    rc, stdout, stderr, _ = launch(mesh_root)
    assert rc == 0, stderr[-4000:]
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, stdout
    res = json.loads(lines[0])
    one = run(mesh_root, CELL, seed=SEED)
    assert res["correct"] and res["checks"] == one["checks"], (res["checks"], one["checks"])
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"converge_ms", "setup_s"}
    tail = stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"]), tail


def test_two_gloo_processes_control_fails(mesh_root):
    """The control through the launcher and gloo: not correct, the rows
    that differ counted over both processes' shards."""
    rc, stdout, stderr, _ = launch(mesh_root, "--control", "cutoff")
    assert rc == 0, stderr[-4000:]
    res = json.loads(stdout.strip().splitlines()[-1])
    assert not res["correct"] and res["checks"]["replicas_differing"]["value"] > 8


@pytest.mark.parametrize("how", ["--die-at", "--stall-at"])
def test_worker_failure_fails_run(mesh_root, how):
    """A worker killed, or stalled, at its third converge (set-up's load
    and the warm iteration behind it): the run exits non-zero, prints no
    result and leaves no process, within the collective timeout (10 s
    here)."""
    rc, stdout, stderr, seconds = launch(mesh_root, how, "3", "--timeout", "10")
    assert rc != 0 and stdout == "", (rc, stdout, stderr[-4000:])
    assert seconds < 60, seconds
    left = subprocess.run(["pgrep", "-f", str(mesh_root / "perfbench" / "cpu_run.py")],
                          capture_output=True, text=True)
    assert left.stdout == "", left.stdout
