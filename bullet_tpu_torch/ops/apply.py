"""Apply per-peer op batches to the replica tables.

The device half of the write path: each simulated peer applies its queued
local puts. The local-put rule is the merge's winner-select, applied one
column of ops across all P peers at a time (gather -> lexmax -> scatter),
in the column order of the reference's scan, which the applied count
depends on.

Padding convention: a no-op is ``cls=0`` (ABSENT always loses), so padded
batches need no masks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .merge import TableState, lex_gt


class OpBatch(NamedTuple):
    """A step's local writes, dense [P, B] int32 (B = max ops/peer/step).

    ``slot`` is the interned leaf-path id; ``cls/khi/klo/vid`` the encoded
    value; ``ctr`` the writer's Lamport stamp; writer is implicit (row p),
    tick is the step counter (passed to ``apply_ops``).
    """

    slot: torch.Tensor
    cls: torch.Tensor
    khi: torch.Tensor
    klo: torch.Tensor
    vid: torch.Tensor
    ctr: torch.Tensor


def _op_keys(cls, khi, klo, vid, writer, ctr, mode: str):
    if mode == "reference":
        return (cls, khi, klo, vid, writer, ctr)
    return (ctr, cls, khi, klo, vid, writer)


def apply_ops(
    table: TableState, ops: OpBatch, tick: int, mode: str = "reference",
    first_peer: int = 0,
) -> Tuple[TableState, torch.Tensor]:
    """Apply a [P, B] op batch in place; returns (table, applied_count).

    An op lands iff it strictly beats the current entry under the mode's
    priority order. The (row, slot) pairs of one column are unique, so
    each column's scatter is deterministic. ``first_peer`` is the peer id
    of row 0 (a shard of a sharded table), the writer of its ops."""
    num_peers = table.cls.shape[0]
    device = table.cls.device
    rows = torch.arange(num_peers, dtype=torch.int64, device=device)
    writer = (rows + first_peer).to(torch.int32)
    tick_t = torch.full((num_peers,), tick, dtype=torch.int32, device=device)
    applied = torch.zeros((), dtype=torch.int64, device=device)
    for b in range(ops.slot.shape[1]):
        slot, ocls, okhi, oklo, ovid, octr = (f[:, b] for f in ops)
        idx = (rows, slot.to(torch.int64))
        cur = [f[idx] for f in table]
        cur_keys = _op_keys(*cur[:6], mode)
        op_keys = _op_keys(ocls, okhi, oklo, ovid, writer, octr, mode)
        # padding ops are cls=0 (ABSENT) and must never land — without this
        # gate they'd win writer tie-breaks against absent entries
        win = lex_gt(op_keys, cur_keys) & (ocls > 0)
        new_vals = (ocls, okhi, oklo, ovid, writer, octr, tick_t)
        for f, c, v in zip(table, cur, new_vals):
            f.index_put_(idx, torch.where(win, v, c))
        applied += win.sum()
    return table, applied.to(torch.int32)


def pad_ops(ops_list, num_peers: int, batch: int, device) -> OpBatch:
    """Host helper: list of per-peer op tuples -> a dense OpBatch.

    ``ops_list[p]`` is a list of (slot, cls, khi, klo, vid, ctr). Padding is
    all-zeros (cls=0 ⇒ guaranteed loser), slot 0 — harmless by construction.
    """
    out = [np.zeros((num_peers, batch), dtype=np.int32) for _ in range(6)]
    for p, ops in enumerate(ops_list):
        for b, op in enumerate(ops):
            for f in range(6):
                out[f][p, b] = op[f]
    return OpBatch(*(torch.from_numpy(a).to(device) for a in out))
