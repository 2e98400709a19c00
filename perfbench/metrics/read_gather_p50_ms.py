"""read_gather_p50_ms: the median (nearest rank) over the window's ``get``
spans of their ``get.gather`` child, in ms: the index copies to the
device, the gather and the read-back of a record read."""

from perfbench.spans import child_ns, window
from perfbench.yardstick import percentile


def read(run):
    spans = window(run)
    if spans is None:
        return None
    p = percentile(list(child_ns(spans, "get", "get.gather").values()), 50)
    return None if p is None else p / 1e6
