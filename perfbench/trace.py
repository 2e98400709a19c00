"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, CUDA activity only, kept in memory (no chrome trace is
written), reduced to device intervals on the host's epoch clock. Only the
events of this process's card are kept: on a mesh of processes, rank 0's
card."""

from __future__ import annotations

import bisect
from typing import List, Tuple

import torch

# The trace loses the first few device events after the profiler starts (on
# an H100 a window's first 2-4 launches went missing): marker kernels,
# launched and synchronised before the window opens, absorb that loss and
# are left out of every reading.
LEAD_IN = 16
MARKER = "spin_kernel"  # the kernel torch.cuda._sleep launches


class DeviceTrace:
    """Context manager: profile the device while open; ``events`` then holds
    (name, start_ns, end_ns) of every operation on the current card, on
    the clock of ``time.time_ns()`` (kineto's), markers left out."""

    def __init__(self) -> None:
        self.events: List[Tuple[str, int, int]] = []
        self._prof = None

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        from torch.autograd import DeviceType

        card = torch.cuda.current_device()
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.device_index() != card:
                continue
            name = e.name()
            if MARKER in name:
                continue
            start = e.start_ns()
            out.append((name, start, start + e.duration_ns()))
        self.events = out
        self._prof = None


def breakdown(run, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    device's idle time by the harness's span the host was in."""
    w0, w1 = run.window_ns
    by_op: dict = {}
    for name, start, end in run.device_events:
        if start >= w0 and end <= w1:
            by_op[name] = by_op.get(name, 0) + (end - start)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(run.spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle: dict = {}
    for a, b in run.busy().gaps(w0, w1):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][0] if i >= 0 and spans[i][2] > mid else "between spans"
        idle[name] = idle.get(name, 0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[name[:160], ns / 1e9] for name, ns in ops],
        "idle_gaps": [[f"idle in {name}", ns / 1e9] for name, ns in gaps],
    }
