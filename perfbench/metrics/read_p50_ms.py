"""read_p50_ms: the median (nearest rank) of the same reads as
read_p95_ms."""

from perfbench.yardstick import percentile


def read(run):
    p = percentile(run.read_s, 50)
    return None if p is None else 1000.0 * p
