"""Plain reference of the gossip round loop on any topology, for a packed
table's columns.

A round takes the neighbour matrix's slots k = 0 .. D-1 in turn: in slot k
every row p whose slot k holds a neighbour q (not -1) merges q's entry as
slot k-1 left it, keeping whichever of the two wins under the CRT's order,
and the round's count is the number of merges the neighbour won, over
every slot. The loop runs rounds until one counts 0, or ``max_rounds``.

The order is the one ``crt_winners.py`` states for the numbers a run
writes, read on the packed entry ``(khi, klo, cv)``, ``cv = cls << 28 |
vid``: the class first, then the number's key (``khi``, then ``klo``), then
the interned value's id. A missing neighbour is skipped: every entry a run
stores is at or above the all-zero (absent) entry, which therefore never
wins. Plain PyTorch on whatever device the table is on; imports nothing of
the program.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

CV_SHIFT = 28


def beats(b: List[torch.Tensor], a: List[torch.Tensor]) -> torch.Tensor:
    """Where packed entry ``b`` wins over ``a`` strictly: (cls, khi, klo,
    cv) compared in turn."""
    keys_b = (b[2] >> CV_SHIFT, b[0], b[1], b[2])
    keys_a = (a[2] >> CV_SHIFT, a[0], a[1], a[2])
    gt = torch.zeros_like(b[0], dtype=torch.bool)
    eq = torch.ones_like(b[0], dtype=torch.bool)
    for kb, ka in zip(keys_b, keys_a):
        gt |= eq & (kb > ka)
        eq &= kb == ka
    return gt


def rounds(neighbors: np.ndarray, table: List[torch.Tensor],
           max_rounds: int) -> Tuple[List[torch.Tensor], int, int]:
    """The round loop on ``table`` (khi, klo, cv: int32 [P, C] each, C
    columns) over ``neighbors`` (int [P, D], -1 = none). Returns (the table
    it leaves, new tensors; the rounds run; the last round's count, summed
    as an int32 wraps)."""
    nb = torch.as_tensor(np.asarray(neighbors), dtype=torch.int64, device=table[0].device)
    slots = []
    for k in range(nb.shape[1]):
        rows = torch.nonzero(nb[:, k] >= 0).flatten()
        if rows.numel():
            slots.append((rows, nb[rows, k]))
    fields = [f.clone() for f in table]
    done, count = 0, 1
    while done < max_rounds and count != 0:
        total = 0
        for rows, src in slots:
            cur = [f[rows] for f in fields]
            got = [f[src] for f in fields]
            take = beats(got, cur)
            total += int(take.sum())
            for f, g, c in zip(fields, got, cur):
                f[rows] = torch.where(take, g, c)
        done += 1
        count = (total + (1 << 31)) % (1 << 32) - (1 << 31)
    return fields, done, count
