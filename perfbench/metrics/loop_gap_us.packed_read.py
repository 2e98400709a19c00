"""loop_gap_us.packed_read: ``loop_gap_us`` in packed.read-mostly, moving ``ops_per_s``.
The cell's dozen 2 ms converges a window spread too widely from run to run
for ``converge_ms.read_mostly``'s bound, so the converge is read there per
layer under names of its own (PERF.md, section 2)."""

from perfbench.metrics.loop_gap_us import read  # noqa: F401
