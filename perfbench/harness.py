"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line's content.

Everything particular to a cell is found by name in ``BENCHMARK.json``: the
configuration's file (its ``file``), the traffic mix
(``perfbench/traffic/<traffic>.json``, read by ``generator.py``), the mix's
read kind (``perfbench/reads/<read>.py``), each metric's reader
(``perfbench/metrics/<metric>.py``) and the configuration's reference
(``perfbench/reference/<reference>.py``).

The closed loop: each iteration writes a batch with ``put_bulk``, applies it
with ``step(0)``, converges with ``run_until_converged``, synchronises, and
then (read mixes) reads with ``get``. The next iteration waits for the
last. Nothing of the program is compiled in the window: its CUDA
kernels are built (or found built) before the first set-up converge.

A configuration with ``shards`` above 1 runs on a mesh of that many
processes, one a card (``launch.py``), each holding one shard: every process
runs this same function with the same seed, so the port sees the same calls
in the same order; a converge ends once every card has drained (``Team``),
and rank 0 alone times, traces and judges.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .generator import Traffic
from .yardstick import Busy, percentile
from .ycsb import key_names

# modules the process must not hold once the window has closed, compared by
# whole top-level name: bullet_tpu_torch is the port, bullet_tpu the JAX
# package it was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "bullet_tpu")
# the random stream the check's sample of replicas is drawn from
CHECK_STREAM = 1 << 40
# replicas, besides the loading peer and its antipode, whose every leaf the
# check reads back
SAMPLED_PEERS = 6
# the most warm iterations that wait for a RankIndex's first respread
WARM_BATCHES_MAX = 16


@dataclass
class Batch:
    t: int
    distinct_leaves: int
    put_s: float
    apply_s: float
    loop_s: float
    launches: int
    residual: int
    respreads: Optional[int]  # the RankIndex's respreads in the batch; None without one
    span_ns: tuple  # (start, end) of put through the loop's end, epoch ns

    @property
    def converge_s(self) -> float:
        return self.put_s + self.apply_s + self.loop_s


@dataclass
class Run:
    """What one run measured: the readers in ``metrics/`` take it alone."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window_s: float = 0.0
    window_ns: tuple = (0, 0)
    batches: List[Batch] = field(default_factory=list)
    read_s: List[float] = field(default_factory=list)
    reads: int = 0
    writes: int = 0
    failed: int = 0
    device_kind: str = ""
    # (name, start_ns, end_ns) of the harness's spans in the window
    spans: List[tuple] = field(default_factory=list)
    # device operations (name, start_ns, end_ns) with --trace 1, else None
    device_events: Optional[list] = None
    _busy: Optional[Busy] = None

    def busy(self) -> Optional[Busy]:
        """The union of the device's busy intervals, None without a trace."""
        if self.device_events is None:
            return None
        if self._busy is None:
            self._busy = Busy((s, e) for _, s, e in self.device_events)
        return self._busy


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"{what} {name!r} is not in BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A cell's entries and files, found by the names in BENCHMARK.json."""

    def __init__(self, root: Path, workload: str) -> None:
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = bench
        self.cell = find(bench["workloads"], workload, "workload")
        entry = find(bench["configs"], self.cell["config"], "config")
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.mix = json.loads(
            (self.root / "perfbench" / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.reference = load_module(
            self.root / "perfbench" / "reference" / f"{self.config['reference']}.py",
            f"perfbench_reference_{self.config['reference']}")
        read = self.mix.get("read")
        self.reads = None if not read else load_module(
            self.root / "perfbench" / "reads" / f"{read}.py", f"perfbench_read_{read}")

    def metrics(self, trace: bool) -> List[dict]:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind] if applies(m, self.cell["name"])]

    def reader(self, name: str):
        """The metric's reader, ``metrics/<name>.py``."""
        return load_module(self.root / "perfbench" / "metrics" / f"{name}.py",
                           f"perfbench_metric_{name}")


def build_sim(config: dict, device):
    from bullet_tpu_torch import PeerNetworkSim

    mesh = ({"mesh_devices": config["shards"], "use_shard_map": True}
            if config.get("shards", 1) > 1 else {})
    return PeerNetworkSim(
        config["num_peers"], capacity=config["capacity"], topology=config["topology"],
        mode=config["mode"], layout=config["layout"], use_kernels=True, device=device, **mesh)


class Team:
    """The processes that run one cell (one where the sim holds no mesh of
    processes). Every process makes the same calls; rank 0 times, traces
    and judges. Collectives go through ``torch.distributed`` directly, on
    the card under NCCL and on the host under gloo."""

    def __init__(self, sim) -> None:
        mesh = getattr(sim, "mesh", None)
        self.distributed = mesh is not None and mesh.distributed
        self.rank = mesh.rank if self.distributed else 0
        self.world = torch.distributed.get_world_size() if self.distributed else 1
        self.wire = None
        if self.distributed:
            nccl = torch.distributed.get_backend() == "nccl"
            self.wire = mesh.home if nccl else torch.device("cpu")

    def sum(self, values: list) -> list:
        """Integers summed element by element over the processes."""
        if not self.distributed:
            return list(values)
        t = torch.tensor(values, dtype=torch.int64, device=self.wire)
        torch.distributed.all_reduce(t)
        return t.tolist()

    def join(self) -> None:
        """Returns once every process has reached it: after each process
        synchronised its card, every card has drained."""
        self.sum([0])

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, in every process."""
        return bool(self.sum([int(flag) if self.rank == 0 else 0])[0])

    def each(self, value: int) -> list:
        """Every process's ``value``, by rank."""
        return self.sum([value if r == self.rank else 0 for r in range(self.world)])

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of process ``src`` (a buffer of its shape elsewhere)."""
        if not self.distributed:
            return t
        w = t.to(self.wire)
        torch.distributed.broadcast(w, src=src)
        return w.to(t.device)


def _rows_differing(fields, first, rows_per_block: int):
    """Flags of the rows of [R, N] ``fields`` unlike ``first`` ([1, N] a
    field) in any slot or field."""
    differing = None
    for f, one in zip(fields, first):
        flags = torch.zeros(f.shape[0], dtype=torch.bool, device=f.device)
        for r0 in range(0, f.shape[0], rows_per_block):
            flags[r0:r0 + rows_per_block] = (f[r0:r0 + rows_per_block] != one).any(dim=1)
        differing = flags if differing is None else differing | flags
    return differing


def replicas_differing(sim, team: Team, rows_per_block: int = 64) -> int:
    """Replicas whose stored entries differ from replica 0's in any slot or
    field: the program's table read as it stands, on its devices. On a mesh
    replica 0's owner gives its row to every process, each compares its own
    shards' rows with it, and the counts are summed over the processes."""
    from bullet_tpu_torch.parallel.mesh import ShardedTable

    table = sim.table
    if not isinstance(table, ShardedTable):
        return int(_rows_differing(table, [f[0:1] for f in table], rows_per_block).sum())
    mesh = table.mesh
    nf, n = len(table.first), table.shape[1]
    home = table.shards[0]
    row0 = (torch.stack([f[0] for f in home]) if home is not None
            else torch.empty((nf, n), dtype=table.first[0].dtype, device=mesh.home))
    row0 = team.broadcast(row0.to(mesh.home), mesh.owners[0])
    count = 0
    for i, shard in table.local():
        first = [r[None].to(mesh[i]) for r in row0]
        count += int(_rows_differing(shard, first, rows_per_block).sum())
    return team.sum([count])[0]


def as_floats(values) -> np.ndarray:
    return np.array([np.nan if v is None or isinstance(v, (dict, str, bool)) else v
                     for v in values], dtype=np.float64)


def same(got, want) -> bool:
    """``got`` is ``want`` exactly: numbers (not booleans) of equal value,
    dicts of the same keys, each the same."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(same(got[k], v) for k, v in want.items()))
    return type(got) in (int, float) and got == want


def respreads(sim) -> Optional[int]:
    """The RankIndex's respreads so far (its ``epoch``), None on a layout
    without one."""
    index = getattr(sim, "rank_index", None)
    return None if index is None else int(index.epoch)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launches() -> int:
    from bullet_tpu_torch import _build

    return sum(_build.LAUNCHES.values())


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None, control: Optional[str] = None, log=print) -> dict:
    """One run; returns the result line's object (without printing it), or
    None in a process of a mesh other than rank 0. ``log_checks`` prints
    its checks.

    ``control="cutoff"`` runs the control: every converge capped one round
    short of the ring's diameter, the program's own ``max_rounds`` path."""
    t0 = time.perf_counter() if t0 is None else t0
    if control not in (None, "cutoff"):
        raise ValueError(f"unknown control {control!r}")
    spec = Cell(root, workload)
    cell, config, mix = spec.cell, spec.config, spec.mix
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    p, fields, n_rec = config["num_peers"], config["fields_per_record"], config["records"]
    traffic = Traffic(mix, n_rec, fields, p, seed)

    # seconds since the process started at which each step of set-up ended
    marks = {"start": time.perf_counter() - t0}
    sim = build_sim(config, device)
    team = Team(sim)
    marks["sim"] = time.perf_counter() - t0
    keys = key_names(n_rec)
    record_paths = [f"{config['table']}/{k}" for k in keys]
    slots = sim.host.intern_batch(
        [f"{r}/field{j}" for r in record_paths for j in range(fields)]).astype(np.int32)
    interned = len(sim.host.paths)
    if interned > config["capacity"]:
        raise RuntimeError(f"{interned} interned paths overflow {config['capacity']} slots")
    max_rounds = sim.topology.diameter - 1 if control == "cutoff" else None
    marks["interned"] = time.perf_counter() - t0

    n_leaves = n_rec * fields
    op_log = []  # (peers, leaves, values) of every batch, load first
    read_log = []  # (t, records, fields, got) of every read block
    reads = spec.reads

    # YCSB's load phase: every leaf written once at one peer, converged
    load_peer = int(config["load_peer"])
    sim.put_bulk(load_peer, slots, np.zeros(n_leaves, dtype=np.int64))
    sim.step(0)
    sync(device)
    marks["load_applied"] = time.perf_counter() - t0
    sim.run_until_converged()
    sync(device)
    marks["load_converged"] = time.perf_counter() - t0
    if sim.last_residual != 0:
        raise RuntimeError(f"the load did not converge: residual {sim.last_residual}")
    op_log.append((np.full(n_leaves, load_peer), np.arange(n_leaves), np.zeros(n_leaves)))
    run = Run(cell, config, mix, setup_s=0.0)
    clock_off = time.time_ns() - time.perf_counter_ns()

    def iteration(t: int, record: bool) -> None:
        g0 = time.perf_counter_ns()
        it = traffic.iteration(t)
        paths = [] if reads is None else [
            reads.path(record_paths[r], f)
            for r, f in zip(it.read_records.tolist(), it.read_fields.tolist())]
        e0 = respreads(sim)
        s0 = time.perf_counter_ns()
        sim.put_bulk(it.peers, slots[it.leaves], it.values)
        s1 = time.perf_counter_ns()
        sim.step(0)
        sync(device)
        s2 = time.perf_counter_ns()
        l0 = launches()
        sim.run_until_converged(max_rounds)
        sync(device)
        team.join()
        s3 = time.perf_counter_ns()
        l1 = launches()
        e1 = respreads(sim)
        # no residual reported (None) counts as not converged
        residual = -1 if sim.last_residual is None else int(sim.last_residual)
        op_log.append((it.peers, it.leaves, it.values))
        got, lat = [], []
        for peer, path in zip(it.read_peers.tolist(), paths):
            r0 = time.perf_counter_ns()
            value = sim.get(peer, path)
            lat.append(time.perf_counter_ns() - r0)
            got.append(value)
        s4 = time.perf_counter_ns()
        read_log.append((t, it.read_records, it.read_fields, got))
        if not record:
            return
        run.batches.append(Batch(
            t, 0, (s1 - s0) / 1e9, (s2 - s1) / 1e9,
            (s3 - s2) / 1e9, l1 - l0, residual, None if e0 is None else e1 - e0,
            (s0 + clock_off, s3 + clock_off)))
        run.writes += len(it.peers)
        run.reads += len(got)
        if residual != 0:
            run.failed += len(it.peers)
        run.read_s.extend(x / 1e9 for x in lat)
        run.spans.extend((name, a + clock_off, b + clock_off) for name, a, b in (
            ("generate", g0, s0), ("put", s0, s1), ("apply", s1, s2), ("loop", s2, s3),
            ("reads", s3, s4)) if b > a)

    # warm iterations of the cell's own shapes, then the window; on a rank
    # layout they go on until the RankIndex has respread once after the
    # load, since on the card that first respread runs 100-350 ms slower
    # than later ones, which would put a one-off cost in the window
    t, warm_ms = 1, []
    loaded = respreads(sim)
    while True:
        w = time.perf_counter()
        iteration(t, record=False)
        warm_ms.append(round(1000 * (time.perf_counter() - w), 3))
        t += 1
        if loaded is None or respreads(sim) > loaded or t > WARM_BATCHES_MAX:
            break
    sync(device)
    run.setup_s = time.perf_counter() - t0
    tracer = None
    if trace and on_card and team.rank == 0:
        from .trace import DeviceTrace

        tracer = DeviceTrace()
    gc_before = [g["collections"] for g in gc.get_stats()]
    with tracer if tracer is not None else contextlib.nullcontext():
        w0 = time.perf_counter_ns()
        going = True
        while going:
            iteration(t, record=True)
            t += 1
            going = team.agree(time.perf_counter_ns() - w0 < seconds * 1e9)
        w1 = time.perf_counter_ns()
    run.window_s = (w1 - w0) / 1e9
    gc_runs = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
    for b in run.batches:
        b.distinct_leaves = len(np.unique(op_log[b.t][1]))
    run.window_ns = (w0 + clock_off, w1 + clock_off)
    if tracer is not None:
        run.device_events = tracer.events
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {found} after the window")

    peaks = team.each(torch.cuda.max_memory_allocated() if on_card else 0)
    run.device_kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    # the check: the program's outputs first (collectives on a mesh), then
    # the reference, which rank 0 alone works out
    differing = replicas_differing(sim, team)
    rng = traffic.rng(CHECK_STREAM)
    sampled = sorted({load_peer, (load_peer + p // 2) % p,
                      *rng.choice(p, min(p, SAMPLED_PEERS), replace=False).tolist()})
    held = {q: as_floats(sim.get_bulk(q, slots)) for q in sampled}
    del sim, slots
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if team.rank != 0:
        return None

    replay = spec.reference.Replay(n_leaves, p)
    reads_wrong = reads_checked = 0
    for (peers, leaves, values), block in zip(op_log, [None] + read_log):
        replay.batch(peers, leaves, values.astype(np.float64))
        if block is None or reads is None:
            continue
        _, records, read_fields, got = block
        rows = replay.records(records, fields)
        reads_wrong += sum(not same(g, reads.answer(row, f))
                           for g, row, f in zip(got, rows, read_fields.tolist()))
        reads_checked += len(got)
    leaves_wrong = sum(int((held[q] != replay.value).sum()) for q in sampled)
    checks = {
        "replicas_differing": {"value": differing, "limit": 0},
        "leaves_wrong": {"value": leaves_wrong, "limit": 0},
        "reads_wrong": {"value": reads_wrong, "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in spec.metrics(bool(trace)):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": run.writes + run.reads,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": run.device_kind,
            "count": int(cell["chips"]),
            "memory_peak_bytes": max(peaks),
        },
    }
    if tracer is not None:
        from .trace import breakdown

        busy = run.busy()
        result["device"]["busy_s"] = busy.covered(*run.window_ns) / 1e9
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = breakdown(run)
    result["checks"] = checks
    log(f"set-up s at the end of each step {marks}; warm iterations ms {warm_ms}; "
        f"peak memory bytes by card {peaks}")
    log(f"interned paths {interned} of {config['capacity']} slots; window {run.window_s} s, "
        f"{len(run.batches)} batches, {run.reads} reads; checked {len(sampled)} replicas' "
        f"{n_leaves} leaves and {reads_checked} reads")
    conv = [round(1000 * b.converge_s, 3) for b in run.batches]
    log(f"converge ms by batch {conv}; respreads by batch {[b.respreads for b in run.batches]}; "
        f"reads s p50 {percentile(run.read_s, 50)} "
        f"p99 {percentile(run.read_s, 99)} max {max(run.read_s, default=None)}; "
        f"gc collections by generation in the window {gc_runs}")
    return result


def log_checks(result: dict, log) -> None:
    """Each number compared, beside its limit: a run's last lines on
    standard error."""
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
