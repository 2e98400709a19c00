"""The program's own spans, as the per-layer readers in ``metrics/`` take
them: the spans of a run's window, those of each batch, and the innermost
span at an instant.

The program (``bullet_tpu_torch.utils.observe``) records spans only while a
``torch.profiler`` records, as a ``--trace 1`` window on the card does
(``trace.DeviceTrace``), on the clock of the device events. Where the
program has no recorder, or recorded nothing in the window (no trace, or
the CPU), ``window`` gives None, and so does every reader built on it.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

# (run, its window's spans) of the last run asked about: the readers of one
# run share one pass over the recorder
_LAST: list = [None, None]


def window(run) -> Optional[list]:
    """The program's spans that lie inside ``run.window_ns``, ordered by
    start, each ``parent`` an index into this list (-1 where the parent is
    not in it); None where there are none."""
    if _LAST[0] is run:
        return _LAST[1]
    try:
        from bullet_tpu_torch.utils.observe import spans
    except ImportError:
        return None
    w0, w1 = run.window_ns
    every = spans()
    keep = [i for i, s in enumerate(every) if s.start_ns >= w0 and s.end_ns <= w1]
    where = {i: j for j, i in enumerate(keep)}
    inside = [every[i]._replace(parent=where.get(every[i].parent, -1)) for i in keep] or None
    _LAST[:] = [run, inside]
    return inside


def by_batch(run, spans: list, name: str) -> List[list]:
    """The spans called ``name`` that start inside each batch's
    ``span_ns`` (put through the loop's end), one list a batch of
    ``run.batches``."""
    out: List[list] = [[] for _ in run.batches]
    starts = [b.span_ns[0] for b in run.batches]
    for s in spans:
        if s.name != name:
            continue
        i = bisect.bisect_right(starts, s.start_ns) - 1
        if i >= 0 and s.start_ns < run.batches[i].span_ns[1]:
            out[i].append(s)
    return out


def child_ns(spans: list, parent: str, child: str) -> dict:
    """ns spent in the children called ``child`` of each span called
    ``parent``, by the parent's index (0 for a parent without one)."""
    out = {i: 0 for i, s in enumerate(spans) if s.name == parent}
    for s in spans:
        if s.name == child and s.parent in out:
            out[s.parent] += s.end_ns - s.start_ns
    return out


def innermost(spans: list, times) -> List[Optional[int]]:
    """For each instant of ``times``, the index of the innermost span
    holding it: of the last span to start at or before it, that span or the
    nearest of its parents that has not ended (spans of one thread nest);
    None where no span holds it."""
    starts = [s.start_ns for s in spans]
    out: List[Optional[int]] = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i].end_ns <= t:
            i = spans[i].parent
        out.append(i if i >= 0 else None)
    return out
