"""The benchmark's frozen arithmetic: peaks, the bytes floor of a converge,
the union of device intervals, percentiles.

A later change to the program never edits this file, so every number the
readers in ``metrics/`` derive from it means the same from PR to PR.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# published HBM bandwidth in bytes/s by the name torch.cuda.get_device_name
# gives (NVIDIA's H100 data sheet, SXM part, at its 700 W limit)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def converge_floor_bytes(num_peers: int, distinct_leaves: int, entry_bytes: int) -> int:
    """The least bytes a batch's write-to-fixed-point must store: every
    replica's entry of every leaf the batch wrote changes (a batch's value
    beats every earlier one), and each entry is written at least once,
    whether by the apply or by a round. Counted from the generated ops
    alone; nothing of the program's stripes, tiles or rounds enters."""
    return int(num_peers) * int(distinct_leaves) * int(entry_bytes)


class Busy:
    """The union of a trace's [start, end) device intervals (ns), as sorted
    disjoint intervals, so that spans of the host can be clipped against
    it."""

    def __init__(self, spans: Iterable[Tuple[int, int]]) -> None:
        starts: List[int] = []
        ends: List[int] = []
        for start, end in sorted(spans):
            if ends and start <= ends[-1]:
                ends[-1] = max(ends[-1], end)
            else:
                starts.append(start)
                ends.append(end)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.ends = np.asarray(ends, dtype=np.int64)
        self._cum = np.concatenate([[0], np.cumsum(self.ends - self.starts)])

    def covered(self, start: int, end: int) -> int:
        """ns of [start, end) during which the device was busy."""
        i0 = int(np.searchsorted(self.ends, start, side="right"))
        i1 = int(np.searchsorted(self.starts, end, side="left"))
        if i0 >= i1:
            return 0
        total = int(self._cum[i1] - self._cum[i0])
        total -= max(0, start - int(self.starts[i0]))
        total -= max(0, int(self.ends[i1 - 1]) - end)
        return total

    def gaps(self, start: int, end: int) -> List[Tuple[int, int]]:
        """The idle intervals inside [start, end)."""
        out, cur = [], start
        i0 = int(np.searchsorted(self.ends, start, side="right"))
        for a, b in zip(self.starts[i0:].tolist(), self.ends[i0:].tolist()):
            if a >= end:
                break
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if cur < end:
            out.append((cur, end))
        return out


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least q% of the
    sample at or below it. None for an empty sample."""
    if not len(values):
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
