"""Frontier-loop helpers shared by the layouts (the packed layout itself is
not ported yet).

The compacting frontier loops carry a compact ids array instead of
per-stripe dirty flags; the frontier step produces the next one. Layout of
the ids array ([t_total + 2] int32, [t_total + 3] for fused steps):

* ``[0, count)``   dirty stripe ids, ascending
* ``[t_total]``    count
* ``[t_total + 1]`` total entries changed in the step that produced it
* ``[t_total + 2]`` max over stripes of the last round that changed the
  stripe (fused steps only)
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# rounds fused per frontier step on the card
STRIPE_FUSE = 8


def frontier_ids_compact(dirty: torch.Tensor, t_total: int) -> torch.Tensor:
    """Initial ids array from bool seed flags [t_total]. The changed-total
    cell starts at 1 (any nonzero: it is only read after the first step
    overwrites it)."""
    nz = torch.nonzero(dirty).flatten().to(torch.int32)
    ids = torch.zeros(t_total + 2, dtype=torch.int32, device=dirty.device)
    ids[: nz.numel()] = nz
    ids[t_total] = nz.numel()
    ids[t_total + 1] = 1
    return ids


def frontier_fused_loop(
    table,
    dirty: torch.Tensor,
    t_total: int,
    max_rounds: int,
    fuse: int,
    round1_fn: Callable,
    roundm_fn: Callable,
) -> Tuple[object, int, int]:
    """Fused phase + single-round tail convergence loop, run on the host
    with one read of the ids array's tail cells per step.

    ``round1_fn(table, ids)`` runs ONE compacting frontier round over the
    [t_total + 2] layout; ``roundm_fn(table, ids)`` runs FUSE rounds over
    the [t_total + 3] layout. The fused phase runs only while a whole fused
    step fits STRICTLY under max_rounds, so any cutoff ends in the
    single-round tail and the reported residual is the true last-round
    change count. Returns (table, classic rounds, last_changed)."""
    ids = torch.cat([
        frontier_ids_compact(dirty, t_total),
        torch.zeros(1, dtype=torch.int32, device=dirty.device),
    ])
    count, changed, _ = ids[t_total:].tolist()
    rounds_done = 0
    last_change = -1
    while count > 0 and rounds_done + fuse < max_rounds:
        table, ids = roundm_fn(table, ids)
        count, changed, max_last = ids[t_total:].tolist()
        if max_last > 0:
            last_change = rounds_done + max_last
        rounds_done += fuse

    ids = ids[: t_total + 2]
    while count > 0 and rounds_done < max_rounds:
        table, ids = round1_fn(table, ids)
        count, changed = ids[t_total:].tolist()
        if changed > 0:
            last_change = rounds_done + 1
        rounds_done += 1
    # classic round count: the first no-change round = last change + 1
    # (1 if rounds ran but nothing ever changed; rounds_done == the
    # max_rounds cutoff when not converged; 0 if nothing was dirty)
    if count > 0:
        rounds = rounds_done
    elif rounds_done == 0:
        rounds = 0
    else:
        rounds = max(last_change + 1, 1)
    last_changed = 0 if count == 0 else max(changed, 1)
    return table, rounds, last_changed
