"""loop_gap_us.read_mostly: ``loop_gap_us`` in the read-mostly cells (256-update batches
between record reads), a metric of its own so that it moves
``converge_ms.read_mostly``, as the read cells' other per-layer metrics do."""

from perfbench.metrics.loop_gap_us import read  # noqa: F401
