"""graph_pass_bw_share: the graph pass's share of its roofline, in %: its
bytes floor over what the card's peak bandwidth moves in the pass's
device time (``graph_pass_ms``'s kernels, inside the converge spans). The
floor (``floor_bytes``) reads every replica's entry of every leaf a batch
wrote once and writes it once: counted from the generated ops alone (the
batch's distinct leaves), nothing of the columns or sectors the program
chose to pass. Nothing to read where no such kernel is found."""

from perfbench.metrics.graph_pass_ms import busy
from perfbench.yardstick import PEAK_BYTES_PER_S


def floor_bytes(num_peers: int, distinct_leaves: int, entry_bytes: int) -> int:
    """The least bytes a pass that settles a batch's columns moves: each of
    the ``distinct_leaves`` columns the batch wrote is read in every one of
    the ``num_peers`` rows and written there once (a scatter batch's value
    reaches every row)."""
    return 2 * int(num_peers) * int(distinct_leaves) * int(entry_bytes)


def read(run):
    kernels = busy(run)
    peak = PEAK_BYTES_PER_S.get(run.device_kind)
    if kernels is None or peak is None:
        return None
    dev_s = sum(kernels.covered(*b.span_ns) for b in run.batches) / 1e9
    if dev_s <= 0:
        return None
    floor = sum(floor_bytes(run.config["num_peers"], b.distinct_leaves,
                            run.config["entry_bytes"]) for b in run.batches)
    return 100.0 * floor / (peak * dev_s)
