"""Observability: step metrics, residual history, profiler traces.

The port of ``bullet_tpu.utils.observe``. ``StepObserver`` records every
``step`` and ``run_until_converged`` of a sim (kind, tick, residual or
rounds, wall seconds, the sim's counters) and hands each event to its
listeners. ``profile_trace`` captures a ``torch.profiler`` trace of a
block of engine work (the card's kernels and copies when a card is
present, the host's operators otherwise) and writes it into a directory
as a Chrome trace, the counterpart of ``jax.profiler.start_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional


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


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace a block of engine work with ``torch.profiler``: the CUDA
    activity when a card is present, the CPU activity otherwise. On exit
    the trace is written into ``logdir`` (made if missing) as
    ``trace_<pid>_<ns>.json``, a Chrome trace (chrome://tracing, Perfetto),
    also when the block raises. The device's first few events after the
    profiler starts can be missing from the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=[activity])
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))
