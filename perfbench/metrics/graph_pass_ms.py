"""graph_pass_ms: the device time of the graph pass's kernels (every kernel
whose name starts with ``bt_converge_graph``: ``csrc/converge_graph.cu``)
inside the batches' converge spans, as the union of their intervals, mean
ms a batch. Nothing to read where no such kernel ran."""

from perfbench.yardstick import Busy

PREFIX = "bt_converge_graph"


def busy(run):
    """The union of the graph pass's kernels, None where none ran."""
    if run.device_events is None or not run.batches:
        return None
    spans = [(s, e) for name, s, e in run.device_events if name.startswith(PREFIX)]
    return Busy(spans) if spans else None


def read(run):
    kernels = busy(run)
    if kernels is None:
        return None
    return sum(kernels.covered(*b.span_ns) for b in run.batches) / len(run.batches) / 1e6
