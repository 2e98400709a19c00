"""exchange_ms: the traced card's device time in NCCL's kernels (every
kernel whose name starts with ``nccl``: ``ncclDevKernel_SendRecv`` for the
slab exchanges, ``ncclDevKernel_AllReduce_*`` for the fold of counts and
the harness's own joins) inside the batches' converge spans, as the union
of their intervals, mean ms a batch. A kernel of NCCL runs from its launch
until its peers' data has moved, so it holds the wait for the other cards
too. Nothing to read on one card, where no NCCL kernel runs."""

from perfbench.yardstick import Busy

PREFIX = "nccl"


def read(run):
    if run.device_events is None or not run.batches:
        return None
    spans = [(s, e) for name, s, e in run.device_events if name.startswith(PREFIX)]
    if not spans:
        return None
    busy = Busy(spans)
    return sum(busy.covered(*b.span_ns) for b in run.batches) / len(run.batches) / 1e6
