"""read_p95_ms: the 95th percentile (nearest rank) over every record read
of the window, each from the ``get`` call to its return."""

from perfbench.yardstick import percentile


def read(run):
    p = percentile(run.read_s, 95)
    return None if p is None else 1000.0 * p
