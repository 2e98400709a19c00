"""CPU tests of the benchmark harness, and the control on the card.

The harness runs here on tiny cells (8 peers x 4,096 slots) added to a
temporary copy of the benchmark by files and entries alone, with the port's
plain versions on the CPU. Tests marked ``card`` need a CUDA card and skip
here.
"""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, ycsb
from perfbench.reference import crt_winners
from perfbench.yardstick import Busy, converge_floor_bytes, percentile

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LAYOUTS = ("packed", "rank1")
MIXES = {"zipf-scatter": (512, 0), "read-mostly": (16, 64)}
TINY_CELLS = [f"{layout}.tiny-{mix}" for layout in LAYOUTS for mix in MIXES]


def add_tiny_cells(root: Path) -> None:
    """Tiny configurations, mixes and cells, by new files and entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for layout in LAYOUTS:
        base = next(c for c in bench["configs"] if c["name"].startswith(layout))
        config = json.loads((root / base["file"]).read_text())
        config.update(name=f"{layout}-tiny", num_peers=8, capacity=4096, records=372,
                      interned_paths=4093)
        path = f"perfbench/configs/{layout}-tiny.json"
        (root / path).write_text(json.dumps(config))
        bench["configs"].append({"name": f"{layout}-tiny", "source": base["source"],
                                 "file": path, "reduced": ["num_peers", "capacity", "records"],
                                 "why": "CPU test size"})
        for mix in MIXES:
            bench["workloads"].append({"name": f"{layout}.tiny-{mix}", "config": f"{layout}-tiny",
                                       "traffic": f"tiny-{mix}", "chips": 1, "why": "CPU test"})
    for mix, (updates, reads) in MIXES.items():
        m = json.loads((root / "perfbench" / "traffic" / f"{mix}.json").read_text())
        m.update(updates_per_batch=updates, reads_per_batch=reads)
        (root / "perfbench" / "traffic" / f"tiny-{mix}.json").write_text(json.dumps(m))
    # a tiny cell reports what its full-size cell reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c in TINY_CELLS if c.replace("tiny-", "") in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(root)
    return root


def run(root, cell, seed=2_147_483_711, seconds=0.3, trace=False, control=None):
    return harness.run_cell(root, cell, seed, seconds, trace, device="cpu", control=control,
                            log=lambda msg: None)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_iteration_matches_reference(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert [k for k in res] == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    # packed.read-mostly reads its converge per layer (PERF.md, section 2)
    want = ({"ops_per_s", "setup_s"} | ({"converge_ms.read_mostly"} if "rank1" in cell else set())
            if "read" in cell else {"converge_ms", "setup_s"})
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_control_fails(tiny_root, cell):
    """The control, every converge capped one round short of the diameter,
    breaks eventual convergence and must come out not correct."""
    res = run(tiny_root, cell, control="cutoff")
    assert not res["correct"]
    assert res["checks"]["replicas_differing"]["value"] > 0


# the faults break the window's path; the set-up's load (two steps) runs
# sound, else set-up itself would stop the run


def _loaded(sim) -> bool:
    return sim.stats["steps"] >= 2


def _no_rounds(orig):
    def converge(self, max_rounds=None):
        return orig(self, max_rounds) if not _loaded(self) else 0
    return converge


def _half_batch(orig):
    def put_bulk(self, peers, paths, values):
        if np.ndim(peers) == 0:
            return orig(self, peers, paths, values)
        return orig(self, peers[::2], paths[::2], values[::2])
    return put_bulk


def _corrupt_entry(orig):
    def converge(self, max_rounds=None):
        rounds = orig(self, max_rounds)
        if _loaded(self):
            self.table[0][3, 7] += 1
        return rounds
    return converge


def _altered_read(orig):
    def get(self, peer, path=""):
        rec = orig(self, peer, path)
        if peer == 1:
            if isinstance(rec, dict):
                rec["field0"] = rec["field0"] + 1
            else:
                rec = rec + 1
        return rec
    return get


def _first_ops(peer, slot):
    """Each (peer, slot) group's first op, in the reductions' output order."""
    pslot = (np.asarray(peer, dtype=np.int64) << 32) | np.asarray(slot, dtype=np.int64)
    order = np.argsort(pslot, kind="stable")
    return order[np.r_[True, np.diff(pslot[order]) != 0]]


def _first_op_kept_packed(orig):
    """The per-(peer, leaf) reduction of a batch keeps each group's first op,
    not its largest: a wrong winner among concurrent writes."""
    from bullet_tpu_torch.ops.packed import CV_SHIFT

    def reduce(peer, slot, cls, khi, klo, vid):
        out = orig(peer, slot, cls, khi, klo, vid)
        first = _first_ops(peer, slot)
        cv = (cls[first].astype(np.int64) << CV_SHIFT) | vid[first]
        return (out[0], out[1], khi[first].astype(np.int32), klo[first].astype(np.int32),
                cv.astype(np.int32))
    return reduce


def _first_op_kept_rank(orig):
    """As ``_first_op_kept_packed``, on the rank layouts' reduction."""
    def reduce(peer, slot, rank, cv):
        out = orig(peer, slot, rank, cv)
        first = _first_ops(peer, slot)
        return (out[0], out[1], np.asarray(rank)[first].astype(np.int32),
                np.asarray(cv)[first].astype(np.int32))
    return reduce


def _gossip_left_out(orig):
    calls = []

    def loop(table, *args, **kwargs):
        calls.append(1)
        return orig(table, *args, **kwargs) if len(calls) == 1 else (table, 1, 0)
    return loop


FAULTS = {
    "state_unchanged": lambda mp, sim: mp.setattr(
        sim, "run_until_converged", _no_rounds(sim.run_until_converged)),
    "half_batch": lambda mp, sim: mp.setattr(sim, "put_bulk", _half_batch(sim.put_bulk)),
    "exchange_left_out": lambda mp, sim: mp.setattr(
        "bullet_tpu_torch.ops.packed.gossip_frontier_packed",
        _gossip_left_out(__import__("bullet_tpu_torch.ops.packed").ops.packed.gossip_frontier_packed)),
    "entry_corrupted": lambda mp, sim: mp.setattr(
        sim, "run_until_converged", _corrupt_entry(sim.run_until_converged)),
    "read_altered": lambda mp, sim: mp.setattr(sim, "get", _altered_read(sim.get)),
    "first_op_kept": lambda mp, sim: (
        mp.setattr("bullet_tpu_torch.ops.packed.reduce_flat_ops",
                   _first_op_kept_packed(__import__("bullet_tpu_torch.ops.packed").ops.packed
                                         .reduce_flat_ops)),
        mp.setattr("bullet_tpu_torch.ops.rank.reduce_flat_ops_rank",
                   _first_op_kept_rank(__import__("bullet_tpu_torch.ops.rank").ops.rank
                                       .reduce_flat_ops_rank))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fault_fails(tiny_root, monkeypatch, fault, layout):
    """A run with the timed path broken underneath comes out not correct."""
    from bullet_tpu_torch import PeerNetworkSim

    FAULTS[fault](monkeypatch, PeerNetworkSim)
    mix = "read-mostly" if fault == "read_altered" else "zipf-scatter"
    res = run(tiny_root, f"{layout}.tiny-{mix}")
    assert not res["correct"], res["checks"]


def test_traced_run_reports_per_layer(tiny_root):
    """On the CPU no device trace exists: the host-clock metrics come, the
    device ones are left out, none reads 0."""
    res = run(tiny_root, "rank1.tiny-read-mostly", trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"put_ms.read_mostly", "apply_ms.read_mostly", "read_p50_ms",
                                   "read_p95_ms", "rank_respreads.read_mostly"}


def test_new_metric_from_files_alone(tiny_root, tmp_path):
    """A per-layer metric is added by a reader file and an entry alone."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    (root / "perfbench" / "metrics" / "batches_in_window.py").write_text(
        "def read(run):\n    return len(run.batches) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "batches_in_window", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "round loop",
                               "moves": "converge_ms",
                               "workloads": ["packed.tiny-zipf-scatter"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run(root, "packed.tiny-zipf-scatter", trace=True)
    assert res["metrics"]["batches_in_window"]["value"] >= 1


def test_new_mix_from_files_alone(tiny_root, tmp_path, monkeypatch):
    """A mix with another value rule and another read kind is added by a
    data file, a read kind's file and entries alone; its reads are checked
    (an altered read fails it)."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    (root / "perfbench" / "reads" / "field_twice.py").write_text(
        "def path(record_path, field):\n    return f'{record_path}/field{field}'\n\n\n"
        "def answer(row, field):\n    return float(row[field])\n")
    mix = {"why": "one-field reads, three values a batch", "updates_per_batch": 24,
           "reads_per_batch": 40, "read": "field_twice", "value_draws": 3}
    (root / "perfbench" / "traffic" / "tiny-field-reads.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "packed.tiny-field-reads", "config": "packed-tiny",
                               "traffic": "tiny-field-reads", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"]:
        if "packed.read-mostly" in m.get("workloads", []):
            m["workloads"].append("packed.tiny-field-reads")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run(root, "packed.tiny-field-reads")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"ops_per_s", "setup_s"}
    from bullet_tpu_torch import PeerNetworkSim

    FAULTS["read_altered"](monkeypatch, PeerNetworkSim)
    res = run(root, "packed.tiny-field-reads")
    assert not res["correct"] and res["checks"]["reads_wrong"]["value"] > 0


def test_same_seed_same_inputs():
    mix = json.loads((ROOT / "perfbench" / "traffic" / "read-mostly.json").read_text())
    a, b = (harness.Traffic(mix, 95325, 10, 1024, 2_200_000_001).iteration(7) for _ in range(2))
    c = harness.Traffic(mix, 95325, 10, 1024, 2_200_000_002).iteration(7)
    fields = ("peers", "leaves", "values", "read_peers", "read_records", "read_fields")
    assert all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)
    assert not np.array_equal(a.leaves, c.leaves)


def test_values_grow_and_differ_within_a_batch():
    """Every value of batch t lies above every value of batch t - 1, and
    concurrent writes to one leaf carry different values."""
    mix = json.loads((ROOT / "perfbench" / "traffic" / "zipf-scatter.json").read_text())
    traffic = harness.Traffic(mix, 95325, 10, 1024, 2_200_000_003)
    a, b = traffic.iteration(5), traffic.iteration(6)
    assert a.values.max() < b.values.min()
    hot = np.bincount(b.leaves).argmax()
    assert len(np.unique(b.values[b.leaves == hot])) > 100


# ---------------------------------------------------------------- yardstick


def test_fnvhash64_matches_ycsb():
    # YCSB's first three hashed keys (insertorder=hashed)
    assert ycsb.key_names(3) == [
        "user6284781860667377211", "user8517097267634966620", "user1820151046732198393"]


def generator_pmf_by_record(records: int, head: int = 1 << 22) -> np.ndarray:
    """Each record's probability under the scrambled Zipfian, worked out from
    the generator's inverse transform: the first ``head`` items exactly, the
    rest of the mass spread evenly (their hashes land uniformly)."""
    z = ycsb.ScrambledZipfian(records)
    theta, n = ycsb.ZIPFIAN_CONSTANT, ycsb.ITEM_COUNT + 1
    lo = (1 + 0.5 ** theta) / ycsb.ZETAN

    def below(x):
        return np.clip(((x / n) ** (1 - theta) + z._eta - 1) / z._eta, lo, 1.0)

    x = np.arange(2, head, dtype=np.float64)
    probs = np.concatenate([[1 / ycsb.ZETAN, 0.5 ** theta / ycsb.ZETAN], below(x + 1) - below(x)])
    rec = np.fmod(ycsb.fnvhash64(np.arange(head)), records)
    return np.bincount(rec, weights=probs, minlength=records) + (1 - probs.sum()) / records


@pytest.mark.parametrize("mix", ["zipf-scatter", "read-mostly"])
def test_distinct_leaves_and_stripes(mix):
    """The generator's distinct leaves and dirty 256-slot stripes a batch
    at the cells' sizes, against the values worked out from its pmf
    (zipf-scatter: about 49,345 leaves on all 4,096 stripes; read-mostly:
    about 249 leaves on about 225 stripes)."""
    records, fields, peers = 95325, 10, 1024
    m = json.loads((ROOT / "perfbench" / "traffic" / f"{mix}.json").read_text())
    k = m["updates_per_batch"]
    leaf_p = np.repeat(generator_pmf_by_record(records) / fields, fields)
    slot = 11 * (np.arange(records * fields) // fields) + 2 + np.arange(records * fields) % fields
    want_leaves = np.sum(1 - (1 - leaf_p) ** k)
    want_stripes = np.sum(1 - (1 - np.bincount(slot // 256, weights=leaf_p)) ** k)
    traffic = harness.Traffic(m, records, fields, peers, 2_147_483_648)
    got = []
    for t in range(20):
        leaves = np.unique(traffic.iteration(t).leaves)
        got.append((len(leaves), len(np.unique(slot[leaves] // 256))))
    got = np.mean(got, axis=0)
    assert abs(got[0] - want_leaves) < 0.01 * want_leaves + 3
    assert abs(got[1] - want_stripes) < 0.02 * want_stripes + 3
    if mix == "zipf-scatter":
        assert 49_000 < want_leaves < 49_700 and want_stripes > 4095
    else:
        assert 245 < want_leaves < 253 and 215 < want_stripes < 235


def test_floor_bytes():
    assert converge_floor_bytes(1024, 49_345, 12) == 1024 * 49_345 * 12
    assert converge_floor_bytes(1024, 249, 4) == 1_019_904


def test_busy_union_and_percentile():
    b = Busy([(0, 10), (5, 20), (30, 40), (50, 55)])
    assert b.covered(0, 100) == 35 and b.covered(8, 35) == 17 and b.covered(21, 29) == 0
    assert b.gaps(0, 60) == [(20, 30), (40, 50), (55, 60)]
    assert percentile(list(range(1, 101)), 95) == 95 and percentile([], 50) is None


def test_reference_carries_stamps_across_batches():
    r = crt_winners.Replay(4, 3)
    r.batch([0, 1, 2], [0, 0, 1], [5, 5, 1])
    assert r.value.tolist()[:2] == [5, 1] and r.writer[0] == 1
    r.batch([1, 1], [1, 1], [1, 1])  # equal value, equal writer: the later stamp
    assert r.writer[1] == 2 and r.value[1] == 1
    r.batch([2], [1], [1])  # writer 2 beats writer 1 on equal values
    assert r.writer[1] == 2 and r.stamp[1] == 2 and r.clock.tolist() == [1, 3, 2]
    assert np.isnan(r.value[2])


# ---------------------------------------------------------------- the files


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_import_scan():
    """No file under perfbench/ imports JAX or the JAX package, and the
    reference imports nothing of the port: whole top-level names."""
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        names = set(imports(f))
        assert not names & {"jax", "jaxlib", "flax", "bullet_tpu"}, f
        if "reference" in f.parts:
            assert "bullet_tpu_torch" not in names, f


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_names_and_units():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in b["workloads"]] + [
            k for c in b["configs"] for k in c["reduced"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert harness.applies(e2e[m["moves"]], w), (m["name"], w)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert one_line(w["why"]) and w["chips"] in (1, 4)
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        cell = [m["name"] for m in b["per_layer"] if harness.applies(m, w["name"])]
        assert cell and "setup_s" in e2e
    for m in metrics:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert all(one_line(word) for word in b["command"]) and b["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_no_card_no_result(tmp_path):
    """Without a card (here), or in a directory that holds only the
    benchmark, run.py exits non-zero and prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, str(root / "perfbench" / "run.py"), "--workload",
             "packed.zipf-scatter", "--seed", "1", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, cwd=root, timeout=300)
        assert out.returncode != 0 and out.stdout == "", out.stderr


# ---------------------------------------------------------------- the card


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_on_card(cell):
    """The control at the cell's own size on three seeds: not correct. A
    sharded cell runs it through ``readings.py``, one process a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.Cell(ROOT, cell)
    if torch.cuda.device_count() < spec.cell["chips"]:
        pytest.skip(f"needs {spec.cell['chips']} CUDA cards")
    seeds = (3_000_000_001, 3_000_000_002, 3_000_000_003)
    if spec.config.get("shards", 1) > 1:
        out = subprocess.run(
            [sys.executable, str(ROOT / "perfbench" / "readings.py"), "--workload", cell,
             "--seeds", ",".join(map(str, seeds)), "--seconds", "3", "--control", "cutoff"],
            capture_output=True, text=True, cwd=ROOT, timeout=1800)
        assert out.returncode == 0, out.stderr[-4000:]
        results = [json.loads(line) for line in out.stdout.splitlines()]
        assert [r["seed"] for r in results] == list(seeds)
    else:
        results = [harness.run_cell(ROOT, cell, seed, 3.0, False, device="cuda",
                                    control="cutoff", log=lambda msg: None) for seed in seeds]
    for seed, res in zip(seeds, results):
        assert not res["correct"], (seed, res["checks"])
