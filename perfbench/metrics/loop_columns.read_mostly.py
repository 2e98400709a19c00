"""loop_columns.read_mostly: ``loop_columns`` in the read-mostly cells (256-update batches
between record reads), a metric of its own so that it moves
``converge_ms.read_mostly``, as the read cells' other per-layer metrics do."""

from perfbench.metrics.loop_columns import read  # noqa: F401
