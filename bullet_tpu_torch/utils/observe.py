"""Observability: step metrics, residual history, program spans,
profiler traces.

The port of ``bullet_tpu.utils.observe``. ``StepObserver`` records every
``step`` and ``run_until_converged`` of a sim (kind, tick, residual or
rounds, wall seconds, the sim's counters) and hands each event to its
listeners. ``span`` marks where the port's own work happens (the write,
apply, round-loop and read paths open one at each layer boundary), and
``spans`` returns what was recorded: spans are recorded while a
``torch.profiler`` is recording, at no other time, on the clock of the
profiler's device events. ``profile_trace`` captures a ``torch.profiler``
trace of a block of engine work (the card's kernels and copies when a card
is present, the host's operators otherwise) and writes it into a directory
as a Chrome trace with the program's spans on a track of their own, the
counterpart of ``jax.profiler.start_trace``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler

# perf_counter_ns() + this = time.time_ns(), the clock of the profiler's
# device events: taken once, so that every span shares one offset
CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
# the most spans the recorder holds; past it spans are dropped and counted
MAX_SPANS = 1 << 22


class Span(NamedTuple):
    """One recorded span: ``start_ns`` and ``end_ns`` on the clock of
    ``time.time_ns()``; ``parent`` the index in ``spans()`` of the span it
    opened inside (on its thread), -1 at a root; ``thread`` the native id of
    its thread; ``attrs`` the integer counts taken at its boundary."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int
    attrs: Dict[str, int]


class _Open:
    """An open span; on exit its record, a tuple of plain values (which the
    garbage collector does not track), joins the recorder's."""

    __slots__ = ("recorder", "name", "attrs", "id", "parent", "start")

    def __init__(self, recorder: "SpanRecorder", name: str, attrs: Dict[str, int]) -> None:
        self.recorder = recorder
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Open":
        rec = self.recorder
        stack = rec._stack()
        self.parent = stack[-1] if len(stack) > 1 else -1
        self.id = next(rec._ids)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter_ns()
        rec = self.recorder
        stack = rec._local.stack
        stack.pop()
        if next(rec._claims) < MAX_SPANS:
            rec._records.append(
                (self.start, end, self.name, self.id, self.parent, stack[0], self.attrs or None))
        else:
            rec._drop()
        return False

    def set(self, **attrs: int) -> None:
        """Record counts at this span's boundary."""
        self.attrs.update(attrs)


class _Off:
    """The shared span site of a recorder that is not recording."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: int) -> None:
        pass


_OFF = _Off()


class SpanRecorder:
    """In-memory spans of the program, up to ``MAX_SPANS``, with a stack of
    open spans per thread. Appends take no lock: ``next`` on a counter and
    ``list.append`` are atomic under the interpreter lock, and the counter
    of closed spans holds the records to ``MAX_SPANS``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        # span ids, never reused: a span open across clear() keeps its parent
        self._ids = itertools.count()
        self.clear()

    def _stack(self) -> list:
        """This thread's stack: its native id, then the ids of its open
        spans."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = [threading.get_native_id()]
            return self._local.stack

    def _drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def spans(self) -> List[Span]:
        records = sorted(self._records[:], key=lambda r: (r[0], r[3]))
        index = {r[3]: i for i, r in enumerate(records)}
        return [Span(name, start + CLOCK_OFFSET_NS, end + CLOCK_OFFSET_NS,
                     index.get(parent, -1), thread, dict(attrs or {}))
                for start, end, name, _, parent, thread, attrs in records]

    def clear(self) -> None:
        with self._lock:
            self._claims = itertools.count()
            self._records: List[tuple] = []
            self.dropped = 0


RECORDER = SpanRecorder()


def span(name: str, **attrs: int):
    """A context manager that records the block as the span ``name`` while a
    ``torch.profiler`` is recording; at any other time a shared context that
    records nothing (one flag test). ``attrs`` and the entered span's
    ``set(**attrs)`` record integer counts. A span never synchronises the
    device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(RECORDER, name, attrs)


def recording() -> bool:
    """Whether span sites record now (a ``torch.profiler`` records): for a
    count that costs work to take, which a site then sets only when it is."""
    return _autograd_profiler._is_profiler_enabled


def spans() -> List[Span]:
    """Every span recorded so far, ordered by start (``RECORDER.dropped``
    counts those past ``MAX_SPANS``; ``RECORDER.clear()`` forgets them)."""
    return RECORDER.spans()


class StepObserver:
    """Attachable observer: step events + residual history.

    >>> obs = StepObserver.attach(sim)
    >>> sim.step(); obs.history[-1]["residual"]
    """

    def __init__(self, sim) -> None:
        self.sim = sim
        self.history: List[Dict] = []
        self.listeners: List[Callable[[Dict], None]] = []
        self._orig_step = sim.step
        self._orig_converge = sim.run_until_converged

    @classmethod
    def attach(cls, sim) -> "StepObserver":
        obs = cls(sim)

        def step(rounds: int = 1):
            t0 = time.perf_counter()
            residual = obs._orig_step(rounds)
            obs._record("step", residual, time.perf_counter() - t0)
            return residual

        def run_until_converged(max_rounds: Optional[int] = None):
            t0 = time.perf_counter()
            rounds = obs._orig_converge(max_rounds)
            obs._record("converge", 0, time.perf_counter() - t0, rounds=rounds)
            return rounds

        sim.step = step
        sim.run_until_converged = run_until_converged
        return obs

    def detach(self) -> None:
        self.sim.step = self._orig_step
        self.sim.run_until_converged = self._orig_converge

    def on_step(self, listener: Callable[[Dict], None]) -> "StepObserver":
        self.listeners.append(listener)
        return self

    def _record(self, kind: str, residual: int, wall: float, **extra) -> None:
        event = {
            "kind": kind,
            "tick": self.sim.tick,
            "residual": residual,
            "wall_s": wall,
            "stats": dict(self.sim.stats),
            **extra,
        }
        self.history.append(event)
        for listener in list(self.listeners):
            try:
                listener(event)
            except Exception:  # noqa: BLE001 - listener isolation
                pass

    def summary(self) -> Dict:
        steps = [e for e in self.history if e["kind"] == "step"]
        return {
            "events": len(self.history),
            "steps": len(steps),
            "total_wall_s": sum(e["wall_s"] for e in self.history),
            "last_residual": self.history[-1]["residual"] if self.history else None,
            "stats": dict(self.sim.stats),
        }


# the Chrome trace's thread id of a thread's spans: a track of their own
# beside the profiler's (native thread ids stay below 2^22)
SPAN_TRACK = 1 << 30


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace a block of engine work with ``torch.profiler``: the CUDA
    activity when a card is present, the CPU activity otherwise. On exit
    the trace is written into ``logdir`` (made if missing) as
    ``trace_<pid>_<ns>.json``, a Chrome trace (chrome://tracing, Perfetto),
    also when the block raises. The program's spans of the block are in it
    as complete events (category ``span``, their counts as ``args``) on one
    track a thread, on the clock of the device events. The device's first
    few events after the profiler starts can be missing from the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=[activity])
    t0 = time.time_ns()
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        t1 = time.time_ns()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, [s for s in spans() if s.start_ns >= t0 and s.end_ns <= t1])


def _add_spans(path: str, block: List[Span]) -> None:
    """Append ``block`` to the Chrome trace at ``path`` as complete events,
    their times relative to the trace's ``baseTimeNanoseconds`` as its own
    events' are."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    for thread in sorted({s.thread for s in block}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TRACK | thread,
                       "args": {"name": f"bullet_tpu_torch spans, thread {thread}"}})
    for s in block:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": SPAN_TRACK | s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.attrs})
    with open(path, "w") as f:
        json.dump(trace, f)
