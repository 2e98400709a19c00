"""The port's program spans (``utils/observe.py``: ``span``, ``spans``) and
the benchmark's readers of them (``perfbench/spans.py``,
``perfbench/metrics/``).

A packed or rank1 sim on the CPU runs put_bulk -> step(0) ->
run_until_converged -> get batches, with path strings or pre-interned
slots. With no profiler open nothing is recorded, and the span sites read
the device no more often than the untraced program. Under
``torch.profiler`` the spans form the named tree, children inside their
parents one after another, on the clock of ``time.time_ns()``; ``loop``
counts the steps and stripes an independent frontier loop counts;
``apply.respread`` appears exactly in the batches whose put respread the
RankIndex; with the card's routes forced, each converge's ``loop`` is one
column pass that counts the dirty columns. Tables, round counts, residuals
and reads are bit-identical with tracing on and off. Each reader gives its
value on a hand-made run and None without spans. Tolerance: exact."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.models.netsim import _clone
from bullet_tpu_torch.ops import packed as pk
from bullet_tpu_torch.ops import rank as rk
from bullet_tpu_torch.utils import observe
from perfbench import harness

torch.set_num_threads(2)

P, N, RECORDS, FIELDS = 16, 4096, 200, 4
ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ("packed", "rank1")
ROUTES = ("paths", "slots")

# each span's parent by name; roots have none
PARENT = {
    "put_bulk": None, "put_bulk.intern": "put_bulk", "put_bulk.encode": "put_bulk",
    "put_bulk.enqueue": "put_bulk", "put_bulk.rank_insert": "put_bulk",
    "step": None, "apply": "step", "apply.rank_sync": "apply",
    "apply.respread": "apply.rank_sync", "apply.respread.luts": "apply.respread",
    "apply.respread.regather": "apply.respread", "apply.reduce": "apply",
    "apply.upload": "apply", "apply.launch": "apply",
    "converge": None, "loop": "converge", "loop.wait": "loop", "converge.finish": "converge",
    "get": None, "get.lookup": "get", "get.gather": "get", "get.decode": "get", "get.tree": "get",
}


def paths_of(rows, fields):
    return [f"t/r{r}/f{f}" for r, f in zip(rows.tolist(), fields.tolist())]


def new_sim(layout):
    """A loaded and converged sim (the RankIndex's first insert is its own
    respread, with nothing on the device to re-gather)."""
    sim = PeerNetworkSim(P, capacity=N, layout=layout, device="cpu", use_kernels=True)
    rows = np.repeat(np.arange(RECORDS), FIELDS)
    fields = np.tile(np.arange(FIELDS), RECORDS)
    sim.put_bulk(0, paths_of(rows, fields), np.zeros(len(rows), dtype=np.int64))
    sim.step(0)
    sim.run_until_converged()
    return sim


def batch(sim, rng, t, route, observe_loop=None, marks=None):
    """One iteration: put_bulk of fresh values, step(0), the converge, five
    record reads. ``observe_loop(sim)`` runs between the apply and the
    converge; ``marks`` gets time.time_ns() as the put begins. Returns
    (rounds, residual, reads)."""
    k = 300
    rows, fields = rng.integers(0, RECORDS, k), rng.integers(0, FIELDS, k)
    paths = paths_of(rows, fields)
    if route == "slots":
        paths = sim.host.paths.lookup_batch(paths).astype(np.int32)
    peers, values = rng.integers(0, P, k), (t << 20) + rng.integers(0, 1 << 20, k)
    if marks is not None:
        marks.append(time.time_ns())
    sim.put_bulk(peers, paths, values)
    sim.step(0)
    if observe_loop is not None:
        observe_loop(sim)
    rounds = sim.run_until_converged()
    reads = [sim.get(int(q), f"t/r{int(r)}")
             for q, r in zip(rng.integers(0, P, 5), rng.integers(0, RECORDS, 5))]
    return rounds, sim.last_residual, reads


def independent_loop(sim):
    """(steps, stripe_steps) of the unfused frontier loop the converge will
    run, counted on a copy of the table from the seed's compacted ids."""
    tile_n = sim._frontier_tile()
    t_total = N // tile_n
    ids = pk.frontier_ids_compact(sim._marks.seed(sim.device), t_total)
    table, wrap = _clone(sim.table), sim.topology.kind == "ring"
    max_rounds = max(2 * sim.topology.diameter + 2, 4)
    steps = stripes = 0
    while int(ids[t_total]) > 0 and steps < max_rounds:
        stripes += int(ids[t_total])
        table, ids = pk.frontier_round_packed(table, ids, tile_n, wrap)
        steps += 1
    return steps, stripes


@pytest.fixture
def respreads(monkeypatch):
    """A rank space small enough that some batches respread and some do
    not."""
    monkeypatch.setattr(rk, "RANK_SPAN", 1 << 19)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_nothing_recorded_without_a_profiler(layout, route, respreads, monkeypatch):
    """No profiler: no span, and the span sites read the device (tolist,
    item, int, cpu, numpy) exactly as often as under a profiler, and never
    synchronise it."""
    reads = {"n": 0}

    def counted(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(*args, **kwargs):
            reads["n"] += 1
            return orig(*args, **kwargs)
        return wrapper

    def refuse():
        raise AssertionError("a span site synchronised the device")

    counts = []
    for traced in (False, True):
        sim = new_sim(layout)
        observe.RECORDER.clear()
        with monkeypatch.context() as m:
            for name in ("tolist", "item", "__int__", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, counted(name))
            m.setattr(torch.cuda, "synchronize", refuse)
            reads["n"] = 0
            rng = np.random.default_rng(5)
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    for t in range(1, 4):
                        batch(sim, rng, t, route)
                assert observe.spans()
            else:
                for t in range(1, 4):
                    batch(sim, rng, t, route)
                assert observe.spans() == [] and observe.RECORDER.dropped == 0
            counts.append(reads["n"])
    assert counts[0] == counts[1] > 0
    assert observe.span("x") is observe.span("y")  # the shared null context


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_traced_sequence_records_the_named_tree(layout, route, respreads):
    sim = new_sim(layout)
    rng = np.random.default_rng(11)
    expect_loops, epochs, marks = [], [], []

    def observe_loop(s):
        expect_loops.append(independent_loop(s))

    observe.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(1, 7):
            e0 = sim.rank_index.epoch if layout == "rank1" else 0
            batch(sim, rng, t, route, observe_loop, marks)
            epochs.append((sim.rank_index.epoch if layout == "rank1" else 0) > e0)
    spans = observe.spans()
    assert observe.RECORDER.dropped == 0
    # the clock: time.time_ns()'s, within 1 ms
    puts = [s.start_ns for s in spans if s.name == "put_bulk"]
    assert len(puts) == len(marks) == 6
    assert all(0 <= p - m < 1_000_000 for p, m in zip(puts, marks)), (puts, marks)
    names = {s.name for s in spans}
    want = set(PARENT) - {"apply.rank_sync", "apply.respread", "apply.respread.luts",
                          "apply.respread.regather", "put_bulk.rank_insert"}
    if route == "slots":
        want.discard("put_bulk.intern")
    if layout == "rank1":
        want |= {"apply.rank_sync", "put_bulk.rank_insert"}
        if any(epochs):
            want |= {"apply.respread", "apply.respread.luts", "apply.respread.regather"}
    assert names == want
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
        if PARENT[s.name] is None:
            assert s.parent == -1, s
            continue
        parent = spans[s.parent]
        assert parent.name == PARENT[s.name], (s, parent)
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    # children of a parent one after another, and four roots a batch
    for i in range(len(spans)):
        kids = [s for s in spans if s.parent == i]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    roots = [s.name for s in spans if s.parent == -1]
    assert roots == ["put_bulk", "step", "converge", "get", "get", "get", "get", "get"] * 6
    # the loop's counts: what the unfused frontier loop did
    loops = [s for s in spans if s.name == "loop"]
    assert [(s.attrs["steps"], s.attrs["stripe_steps"]) for s in loops] == expect_loops
    assert all(s.attrs["waits"] == s.attrs["steps"] + 1 for s in loops)
    assert all(len([c for c in spans if c.name == "loop.wait" and spans[c.parent] is s])
               == s.attrs["waits"] for s in loops)
    # a respread in the apply exactly where the batch's put rose the epoch
    steps = [i for i, s in enumerate(spans) if s.name == "step"]
    regathers = [any(spans[spans[spans[r].parent].parent].parent == i
                     for r, s in enumerate(spans) if s.name == "apply.respread")
                 for i in steps]
    assert regathers == epochs
    inserts = [s.attrs["respread"] for s in spans if s.name == "put_bulk.rank_insert"]
    assert inserts == ([int(e) for e in epochs] if layout == "rank1" else [])
    if layout == "rank1":
        assert any(epochs) and not all(epochs)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tracing_changes_nothing(layout, route, respreads):
    results, tables = [], []
    for traced in (False, True):
        sim = new_sim(layout)
        rng = np.random.default_rng(23)
        with profile(activities=[ProfilerActivity.CPU]) if traced else torch.no_grad():
            out = [batch(sim, rng, t, route) for t in range(1, 6)]
        results.append((out, dict(sim.stats)))
        tables.append(sim.table)
    assert results[0] == results[1]
    assert all(torch.equal(a, b) for a, b in zip(*tables))


def test_the_drop_cap_holds(monkeypatch):
    monkeypatch.setattr(observe, "MAX_SPANS", 5)
    observe.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(8):
            with observe.span("s", i=i) as sp:
                sp.set(j=i)
    got = observe.spans()
    assert [s.attrs for s in got] == [{"i": i, "j": i} for i in range(5)]
    assert observe.RECORDER.dropped == 3
    observe.RECORDER.clear()
    assert observe.spans() == [] and observe.RECORDER.dropped == 0


def test_each_thread_nests_its_own_spans():
    observe.RECORDER.clear()
    go = threading.Barrier(2, timeout=30)

    def work():
        with observe.span("outer"):
            go.wait()
            with observe.span("inner"):
                go.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    spans = observe.spans()
    inner = [s for s in spans if s.name == "inner"]
    assert len(inner) == 2 and len({s.thread for s in inner}) == 2
    for s in inner:
        parent = spans[s.parent]
        assert parent.name == "outer" and parent.thread == s.thread


# ---------------------------------------------------------------- readers

def span(name, start, end, parent=-1, **attrs):
    return observe.Span(name, start, end, parent, 1, attrs)


# a window of 1 ms holding two batches and three reads, a loop span outside
# it, and device intervals that reach past the loop spans (clipped)
SPANS = [
    span("apply.respread", 30_000, 60_000),
    span("converge", 100_000, 390_000),
    span("loop", 110_000, 380_000, 1, steps=4, stripe_steps=100, waits=5, columns=0),
    span("apply.respread", 450_000, 460_000),
    span("loop", 600_000, 800_000, steps=2, stripe_steps=30, waits=3, columns=40),
    span("get", 910_000, 930_000),
    span("get.gather", 912_000, 915_000, 5),
    span("get", 940_000, 950_000),
    span("get.gather", 941_000, 946_000, 7),
    span("get", 960_000, 990_000),
    span("loop", 1_200_000, 1_300_000, steps=100, stripe_steps=9_999, waits=101, columns=7),
]
DEVICE = [("k", 100_000, 150_000), ("k", 300_000, 500_000), ("k", 700_000, 900_000)]
READERS = {
    "loop_stripe_steps": (100 + 30) / 2,
    "loop_columns": (0 + 40) / 2,
    "loop_gap_us": ((270_000 - 40_000 - 80_000) + (200_000 - 100_000)) / 1e3 / 6,
    "respread_ms": (30_000 + 10_000) / 2 / 1e6,
    "read_gather_p50_ms": 3_000 / 1e6,  # of 3,000, 5,000 and 0 ns
    "read_host_p50_ms": 17_000 / 1e6,  # of 17,000, 5,000 and 30,000 ns
}
READERS.update({f"{m}.read_mostly": READERS[m]
                for m in ("loop_stripe_steps", "loop_gap_us", "respread_ms", "loop_columns")})


def synthetic_run():
    batch = lambda t, a, b: harness.Batch(t, 0, 0.0, 0.0, 0.0, 65, 0, None, (a, b))  # noqa: E731
    return harness.Run({}, {}, {}, 0.0, window_s=1e-3, window_ns=(0, 1_000_000),
                       batches=[batch(1, 10_000, 400_000), batch(2, 500_000, 900_000)],
                       device_events=list(DEVICE))


def reader(name):
    return harness.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                               f"perfbench_metric_{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_hand_made_spans(name, monkeypatch):
    monkeypatch.setattr(observe, "spans", lambda: list(SPANS))
    assert reader(name).read(synthetic_run()) == pytest.approx(READERS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_without_spans(name, monkeypatch):
    monkeypatch.setattr(observe, "spans", lambda: [])
    assert reader(name).read(synthetic_run()) is None
    # an older program, without a recorder
    monkeypatch.delattr(observe, "spans")
    assert reader(name).read(synthetic_run()) is None


@pytest.mark.parametrize("name", ["loop_columns", "loop_columns.read_mostly"])
def test_loop_columns_is_silent_on_loops_without_columns(name, monkeypatch):
    """A program whose loops count no columns (one without the column
    pass) gives no reading, where its other loop metrics still read."""
    bare = [s._replace(attrs={k: v for k, v in s.attrs.items() if k != "columns"})
            for s in SPANS]
    monkeypatch.setattr(observe, "spans", lambda: bare)
    assert reader(name).read(synthetic_run()) is None
    assert reader("loop_stripe_steps").read(synthetic_run()) == READERS["loop_stripe_steps"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_column_pass_loop_counts_its_columns(layout, monkeypatch):
    """With the card's routes forced on the CPU a converge is one column
    pass: ``loop`` counts no stripes, one wait (the depth's read-back) and
    the dirty columns the apply tracked; the stripe loops count 0."""
    monkeypatch.setattr(PeerNetworkSim, "_card_routes", lambda self: True)
    sim = new_sim(layout)
    rng = np.random.default_rng(5)
    dirty = []
    observe.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(1, 4):
            batch(sim, rng, t, "slots", lambda s: dirty.append(int(s._marks.columns().sum())))
        sim.put(3, "t/r0/f0", 10 ** 9)
        sim.run_until_converged(max_rounds=sim.topology.diameter)  # capped: the stripe loop
    loops = [s.attrs for s in observe.spans() if s.name == "loop"]
    assert [a["columns"] for a in loops] == dirty + [0] and all(dirty)
    assert all((a["steps"], a["stripe_steps"], a["waits"]) == (0, 0, 1) for a in loops[:-1])
    assert loops[-1]["stripe_steps"] > 0


def test_spans_helper_finds_the_innermost_span(monkeypatch):
    from perfbench import spans as helper

    monkeypatch.setattr(observe, "spans", lambda: list(SPANS))
    run = synthetic_run()
    inside = helper.window(run)
    assert [s.name for s in inside] == [s.name for s in SPANS[:-1]]
    assert [inside[i].parent for i in (2, 6, 8)] == [1, 5, 7]
    at = helper.innermost(inside, [105_000, 120_000, 385_000, 395_000, 913_000, 935_000])
    assert [None if i is None else inside[i].name for i in at] == [
        "converge", "loop", "converge", None, "get.gather", None]
    assert [len(b) for b in helper.by_batch(run, inside, "loop")] == [1, 1]
    # without a device trace the gap cannot be read
    run.device_events = None
    assert reader("loop_gap_us").read(run) is None
