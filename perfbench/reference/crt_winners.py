"""Plain NumPy reference of the CRT's converged state over a run's batches.

What every replica must hold once ``run_until_converged`` has returned
residual 0: for each leaf, the winner over every write so far under the
reference priority for numbers (the largest value, then the largest writer,
then the largest Lamport stamp). Stamps: each peer's clock starts at 0 and
carries from batch to batch; within a batch a peer's ops count clock + 1,
clock + 2, ... in batch order.

``expected_winners`` is a frozen copy of ``chip_smoke.py``'s function of
that name (one batch from empty stamps); ``Replay`` extends it across
batches. Imports nothing of the program: it works the winners out again
from the ops the harness generated.
"""

from __future__ import annotations

import numpy as np


def expected_winners(op_peer, op_leaf, op_val, clock=None):
    """The winning (leaf, value, writer, stamp) of each leaf written in one
    batch, stamps counted on from ``clock`` (int64 [P]; zeros if None)."""
    op_peer = np.asarray(op_peer, dtype=np.int64)
    op_leaf = np.asarray(op_leaf, dtype=np.int64)
    op_val = np.asarray(op_val, dtype=np.float64)
    k = len(op_peer)
    order = np.argsort(op_peer, kind="stable")
    seq = np.empty(k, dtype=np.int64)
    sorted_peer = op_peer[order]
    first = np.r_[0, np.flatnonzero(np.diff(sorted_peer)) + 1]
    group = np.repeat(first, np.diff(np.r_[first, k]))
    seq[order] = np.arange(k) - group
    ctr = seq + 1 + (0 if clock is None else clock[op_peer])
    o = np.lexsort((ctr, op_peer, op_val, op_leaf))
    leaf_s = op_leaf[o]
    last = np.flatnonzero(np.r_[leaf_s[1:] != leaf_s[:-1], True])
    w = o[last]
    return op_leaf[w], op_val[w], op_peer[w], ctr[w]


class Replay:
    """The converged state of ``leaves`` leaves on ``peers`` replicas after
    each batch applied in turn, beginning with every leaf absent."""

    def __init__(self, leaves: int, peers: int) -> None:
        self.value = np.full(leaves, np.nan)
        self.writer = np.full(leaves, -1, dtype=np.int64)
        self.stamp = np.zeros(leaves, dtype=np.int64)
        self.clock = np.zeros(peers, dtype=np.int64)

    def batch(self, op_peer, op_leaf, op_val) -> None:
        op_peer = np.asarray(op_peer, dtype=np.int64)
        if len(op_peer) == 0:
            return
        leaf, val, writer, stamp = expected_winners(op_peer, op_leaf, op_val, self.clock)
        self.clock += np.bincount(op_peer, minlength=len(self.clock))
        old = (self.value[leaf], self.writer[leaf], self.stamp[leaf])
        absent = np.isnan(old[0])
        wins = absent | (val > old[0]) | (val == old[0]) & (
            (writer > old[1]) | (writer == old[1]) & (stamp > old[2]))
        leaf = leaf[wins]
        self.value[leaf] = val[wins]
        self.writer[leaf] = writer[wins]
        self.stamp[leaf] = stamp[wins]

    def records(self, records, fields: int) -> np.ndarray:
        """The values of every field of each record: float64 [len, fields]."""
        records = np.asarray(records, dtype=np.int64)
        return self.value[records[:, None] * fields + np.arange(fields)]
