"""read_host_p50_ms: the median (nearest rank) over the window's ``get``
spans of each span less its ``get.gather`` child, in ms: a record read's
host work (path lookup, decode, tree) without the device round trip."""

from perfbench.spans import child_ns, window
from perfbench.yardstick import percentile


def read(run):
    spans = window(run)
    if spans is None:
        return None
    gather = child_ns(spans, "get", "get.gather")
    host = [spans[i].end_ns - spans[i].start_ns - g for i, g in gather.items()]
    p = percentile(host, 50)
    return None if p is None else p / 1e6
