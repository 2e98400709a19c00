"""loop_launches.read_mostly: ``loop_launches`` in the read-mostly cells (256-update batches
between record reads), a metric of its own so that it takes a bound, or moves
a metric, of its own: the read cells' converge spreads about four times the
scatter cells' (PERF.md, section 2)."""

from perfbench.metrics.loop_launches import read  # noqa: F401
