"""Ring/chain gossip rounds and the compacting dense frontier.

One gossip round on a ring is ``merge(merge(t, roll(t, +1)), roll(t, -1))``
with both neighbours taken from the pre-round table; a chain replaces the
missing neighbour at each end with an all-zero row that is still compared.

Each kernel sits beside its plain PyTorch version:

* ``ring_round`` (``csrc/ring_round.cu``) / ``ring_round_torch``: one round
  over the whole table, in place.
* ``frontier_round_dense`` (``csrc/frontier_dense.cu``) /
  ``frontier_round_dense_torch``: ``m`` rounds over the active slot stripes
  only, in place, returning the next round's compact ids array.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Columns are independent under ring gossip,
so every function here may update its table in place: the port keeps one
table allocation where the reference returned a fresh one.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import _build
from .merge import TableState, lex_gt, priority_keys

# plain versions work on column blocks of at most this many entries per
# field, which bounds their temporaries at large tables
_PLAIN_BLOCK_ELEMS = 1 << 24

FRONTIER_TILE_MAX = 256


def _shifted(vals: List[torch.Tensor], direction: int, wrap: bool):
    """Neighbour view: direction=+1 -> row p-1, direction=-1 -> row p+1."""
    p = vals[0].shape[0]
    out = []
    for f in vals:
        rolled = torch.roll(f, direction, 0)
        if not wrap:
            rolled[0 if direction == 1 else p - 1] = 0
        out.append(rolled)
    return out


def _lexmax(a: List[torch.Tensor], b: List[torch.Tensor], mode: str):
    gt = lex_gt(priority_keys(TableState(*b), mode), priority_keys(TableState(*a), mode))
    return [torch.where(gt, fb, fa) for fa, fb in zip(a, b)], gt


def _round_masks(vals: List[torch.Tensor], wrap: bool, mode: str):
    """Plain version of one ring (wrap) or chain round on [P, W] fields,
    both neighbours from the pre-round fields: (new fields, gt1, gt2), the
    masks of entries the up and the down neighbour won."""
    m1, gt1 = _lexmax(vals, _shifted(vals, 1, wrap), mode)
    m2, gt2 = _lexmax(m1, _shifted(vals, -1, wrap), mode)
    return m2, gt1, gt2


def ring_round_torch(
    table: TableState, mode: str = "reference", wrap: bool = True
) -> Tuple[TableState, torch.Tensor]:
    """Plain version of one ring (wrap=True) or chain round, in place.
    Returns (table, changed) with changed = sum(gt1) + sum(gt2) as int32."""
    p, n = table.cls.shape
    width = max(1, _PLAIN_BLOCK_ELEMS // max(p, 1))
    total = torch.zeros((), dtype=torch.int64, device=table.cls.device)
    for c0 in range(0, n, width):
        c1 = min(n, c0 + width)
        new, gt1, gt2 = _round_masks([f[:, c0:c1] for f in table], wrap, mode)
        for f, v in zip(table, new):
            f[:, c0:c1] = v
        total += gt1.sum() + gt2.sum()
    return table, total.to(torch.int32)


def ring_round(
    table: TableState, mode: str = "reference", wrap: bool = True
) -> Tuple[TableState, torch.Tensor]:
    """One ring or chain round, in place: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Any P, N >= 1."""
    if mode not in ("reference", "lww"):
        raise ValueError(f"unknown merge mode: {mode}")
    device = table.cls.device
    if device.type == "cpu":
        return ring_round_torch(table, mode, wrap)
    _build.require_cuda(device, "ring_round")
    p, n = table.cls.shape
    _build.check_fields(table, (p, n), device, "ring_round")
    lib = _build.library()
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_ring_round(
            _build.pointers(table), count.data_ptr(), p, n, int(wrap),
            int(mode == "lww"), _build.stream_of(device),
        )
    _build.check(err, "ring_round")
    _build.LAUNCHES["ring_round"] += 1
    return table, count[0]


# ------------------------------------------- frontier convergence (dense)


def frontier_tile_n_dense(n: int) -> int:
    """Stripe width of the dense frontier: the widest multiple of 32, at
    most FRONTIER_TILE_MAX, that divides n (0 when none does). One CUDA
    block owns a stripe, one thread a column."""
    t = min(FRONTIER_TILE_MAX, n) // 32 * 32
    while t >= 32 and n % t:
        t -= 32
    return t if t >= 32 else 0


def _ids_len(t_total: int, m: int) -> int:
    return t_total + (3 if m > 1 else 2)


def frontier_round_dense_torch(
    table: TableState, ids: torch.Tensor, tile_n: int, wrap: bool, mode: str,
    m: int = 1,
) -> Tuple[TableState, torch.Tensor]:
    """Plain version of one compacting frontier step: ``m`` rounds over the
    stripes ``ids[:ids[t_total]]``, in place. Returns (table, next ids):
    the stripes whose last round still changed (ascending), their count,
    the changed total, and for m > 1 the max last-changed round. Cells past
    the count are zero."""
    p, n = table.cls.shape
    t_total = n // tile_n
    device = table.cls.device
    out = torch.zeros(_ids_len(t_total, m), dtype=torch.int32, device=device)
    count = int(ids[t_total])
    if count == 0:
        return table, out
    stripes = ids[:count].to(torch.int64)
    changed = torch.zeros(count, dtype=torch.int64, device=device)
    last = torch.zeros(count, dtype=torch.int64, device=device)
    lanes = torch.arange(tile_n, device=device)
    per_block = max(1, _PLAIN_BLOCK_ELEMS // max(p * tile_n, 1))
    for s0 in range(0, count, per_block):
        s1 = min(count, s0 + per_block)
        cols = (stripes[s0:s1, None] * tile_n + lanes).reshape(-1)
        vals = [f.index_select(1, cols) for f in table]
        for k in range(1, m + 1):
            vals, gt1, gt2 = _round_masks(vals, wrap, mode)
            c = (gt1.sum(0) + gt2.sum(0)).reshape(s1 - s0, tile_n).sum(1)
            last[s0:s1] = torch.where(c > 0, k, last[s0:s1])
            changed[s0:s1] += c
        for f, v in zip(table, vals):
            f.index_copy_(1, cols, v)
    keep = stripes[last == m]
    out[: keep.numel()] = keep.to(torch.int32)
    out[t_total] = keep.numel()
    out[t_total + 1] = changed.sum().to(torch.int32)
    if m > 1:
        out[t_total + 2] = last.max().to(torch.int32)
    return table, out


def frontier_round_dense(
    table: TableState, ids: torch.Tensor, tile_n: int, wrap: bool, mode: str,
    m: int = 1,
) -> Tuple[TableState, torch.Tensor]:
    """One compacting frontier step (``m`` fused rounds), in place: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. ``ids`` is
    [t_total + 2] for m = 1, [t_total + 3] for m > 1. Cells of the returned
    ids array past its count are left unwritten by the kernel."""
    if mode not in ("reference", "lww"):
        raise ValueError(f"unknown merge mode: {mode}")
    p, n = table.cls.shape
    if tile_n <= 0 or n % tile_n:
        raise ValueError(f"tile_n {tile_n} does not divide n {n}")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    device = table.cls.device
    if device.type == "cpu":
        return frontier_round_dense_torch(table, ids, tile_n, wrap, mode, m)
    _build.require_cuda(device, "frontier_round_dense")
    if tile_n % 32 or tile_n > FRONTIER_TILE_MAX:
        raise ValueError(
            f"kernel tile_n must be a multiple of 32 <= {FRONTIER_TILE_MAX}, got {tile_n}"
        )
    t_total = n // tile_n
    _build.check_fields(table, (p, n), device, "frontier_round_dense")
    _build.check_fields((ids,), (_ids_len(t_total, m),), device, "frontier ids")
    lib = _build.library()
    ids_out = torch.empty_like(ids)
    stripe_changed = torch.empty(t_total, dtype=torch.int32, device=device)
    stripe_last = torch.empty(t_total, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_frontier_round_dense(
            _build.pointers(table), ids.data_ptr(), ids_out.data_ptr(),
            stripe_changed.data_ptr(), stripe_last.data_ptr(), p, n, tile_n,
            t_total, m, int(wrap), int(mode == "lww"), _build.stream_of(device),
        )
    _build.check(err, "frontier_round_dense")
    _build.LAUNCHES["frontier_round_dense"] += 1
    return table, ids_out


def gossip_frontier_dense(
    table: TableState,
    dirty: torch.Tensor,
    wrap: bool,
    mode: str,
    max_rounds: int,
    fuse: int = 1,
    tile_n: Optional[int] = None,
) -> Tuple[TableState, int, int]:
    """Dense frontier convergence loop (ring/chain), in place: per round
    only stripes still changing are touched. ``dirty`` is a bool [t_total]
    seed. Returns (table, classic rounds, last_changed), bit-identical to
    the classic all-stripes loop, also with ``fuse`` > 1, which runs FUSE
    rounds per step and reconstructs the exact classic round count. The
    host reads one small slice of the ids array per step."""
    from .packed import frontier_fused_loop, frontier_ids_compact

    p, n = table.cls.shape
    if tile_n is None:
        tile_n = frontier_tile_n_dense(n)
    t_total = n // tile_n

    def step(m):
        return lambda tbl, ids: frontier_round_dense(tbl, ids, tile_n, wrap, mode, m)

    if fuse > 1:
        return frontier_fused_loop(
            table, dirty, t_total, max_rounds, fuse, step(1), step(fuse)
        )
    ids = frontier_ids_compact(dirty, t_total)
    rounds = 0
    count = int(ids[t_total])
    while count > 0 and rounds < max_rounds:
        table, ids = frontier_round_dense(table, ids, tile_n, wrap, mode)
        count = int(ids[t_total])
        rounds += 1
    # 0 iff the frontier is empty at exit
    last_changed = 0 if count == 0 else int(ids[t_total + 1])
    return table, rounds, last_changed
