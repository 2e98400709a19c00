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

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import _build
from .merge import TableState, lex_gt, priority_keys

# plain versions work on column blocks of at most this many entries per
# field, which bounds their temporaries at large tables
_PLAIN_BLOCK_ELEMS = 1 << 24

FRONTIER_TILE_MAX = 256

# beats(b_fields, a_fields) -> bool mask of entries where b strictly wins;
# the plain versions below take one, so every layout shares them
Beats = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], torch.Tensor]


def dense_beats(mode: str) -> Beats:
    """The dense layout's priority order under ``mode``."""
    return lambda b, a: lex_gt(
        priority_keys(TableState(*b), mode), priority_keys(TableState(*a), mode)
    )


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


def _lexmax(a: List[torch.Tensor], b: List[torch.Tensor], beats: Beats):
    gt = beats(b, a)
    return [torch.where(gt, fb, fa) for fa, fb in zip(a, b)], gt


def _round_masks(vals: List[torch.Tensor], wrap: bool, beats: Beats):
    """Plain version of one ring (wrap) or chain round on [P, W] fields,
    both neighbours from the pre-round fields: (new fields, gt1, gt2), the
    masks of entries the up and the down neighbour won."""
    m1, gt1 = _lexmax(vals, _shifted(vals, 1, wrap), beats)
    m2, gt2 = _lexmax(m1, _shifted(vals, -1, wrap), beats)
    return m2, gt1, gt2


def rounds_torch(
    fields: Sequence[torch.Tensor], wrap: bool, beats: Beats, m: int = 1,
    store: bool = True,
) -> torch.Tensor:
    """Plain version of ``m`` ring (wrap=True) or chain rounds on [P, N]
    fields, in place unless ``store`` is False (then nothing is written:
    the count-only probe). Columns are independent, so it runs on column
    blocks. Returns the changed count summed over the rounds, sum(gt1) +
    sum(gt2) per round, as int32."""
    p, n = fields[0].shape
    width = max(1, _PLAIN_BLOCK_ELEMS // max(p, 1))
    total = torch.zeros((), dtype=torch.int64, device=fields[0].device)
    for c0 in range(0, n, width):
        c1 = min(n, c0 + width)
        vals = [f[:, c0:c1] for f in fields]
        for _ in range(m):
            vals, gt1, gt2 = _round_masks(vals, wrap, beats)
            total += gt1.sum() + gt2.sum()
        if store:
            for f, v in zip(fields, vals):
                f[:, c0:c1] = v
    return total.to(torch.int32)


def ring_round_torch(
    table: TableState, mode: str = "reference", wrap: bool = True
) -> Tuple[TableState, torch.Tensor]:
    """Plain version of one ring (wrap=True) or chain round, in place.
    Returns (table, changed) with changed = sum(gt1) + sum(gt2) as int32."""
    return table, rounds_torch(table, wrap, dense_beats(mode))


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


def frontier_tile_n(n: int) -> int:
    """Stripe width of the frontier of every layout, for any P: the widest
    multiple of 32, at most FRONTIER_TILE_MAX, that divides n (0 when none
    does). One CUDA block owns a stripe, one thread a column. The port's
    own width, not the TPU's VMEM-derived one."""
    t = min(FRONTIER_TILE_MAX, n) // 32 * 32
    while t >= 32 and n % t:
        t -= 32
    return t if t >= 32 else 0


def _ids_len(t_total: int, m: int) -> int:
    return t_total + (3 if m > 1 else 2)


def frontier_round_torch(
    fields: Sequence[torch.Tensor], ids: torch.Tensor, tile_n: int, wrap: bool,
    beats: Beats, m: int = 1,
) -> torch.Tensor:
    """Plain version of one compacting frontier step on [P, N] fields:
    ``m`` rounds over the stripes ``ids[:ids[t_total]]``, in place. Returns
    the next ids array: the stripes whose last round still changed
    (ascending), their count, the changed total, and for m > 1 the max
    last-changed round. Cells past the count are zero."""
    p, n = fields[0].shape
    t_total = n // tile_n
    device = fields[0].device
    out = torch.zeros(_ids_len(t_total, m), dtype=torch.int32, device=device)
    count = int(ids[t_total])
    if count == 0:
        return out
    stripes = ids[:count].to(torch.int64)
    changed = torch.zeros(count, dtype=torch.int64, device=device)
    last = torch.zeros(count, dtype=torch.int64, device=device)
    lanes = torch.arange(tile_n, device=device)
    per_block = max(1, _PLAIN_BLOCK_ELEMS // max(p * tile_n, 1))
    for s0 in range(0, count, per_block):
        s1 = min(count, s0 + per_block)
        cols = (stripes[s0:s1, None] * tile_n + lanes).reshape(-1)
        vals = [f.index_select(1, cols) for f in fields]
        for k in range(1, m + 1):
            vals, gt1, gt2 = _round_masks(vals, wrap, beats)
            c = (gt1.sum(0) + gt2.sum(0)).reshape(s1 - s0, tile_n).sum(1)
            last[s0:s1] = torch.where(c > 0, k, last[s0:s1])
            changed[s0:s1] += c
        for f, v in zip(fields, vals):
            f.index_copy_(1, cols, v)
    keep = stripes[last == m]
    out[: keep.numel()] = keep.to(torch.int32)
    out[t_total] = keep.numel()
    out[t_total + 1] = changed.sum().to(torch.int32)
    if m > 1:
        out[t_total + 2] = last.max().to(torch.int32)
    return out


def frontier_round_dense_torch(
    table: TableState, ids: torch.Tensor, tile_n: int, wrap: bool, mode: str,
    m: int = 1,
) -> Tuple[TableState, torch.Tensor]:
    """Plain version of one compacting dense frontier step (see
    ``frontier_round_torch``). Returns (table, next ids)."""
    return table, frontier_round_torch(table, ids, tile_n, wrap, dense_beats(mode), m)


def check_frontier_step(table, tile_n: int, m: int) -> None:
    """Raise unless ``tile_n`` stripes the table and ``m`` >= 1."""
    n = table[0].shape[1]
    if tile_n <= 0 or n % tile_n:
        raise ValueError(f"tile_n {tile_n} does not divide n {n}")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")


def launch_frontier_step(
    name: str, table, ids: torch.Tensor, tile_n: int, m: int, *extra: int
) -> torch.Tensor:
    """Launch the frontier kernel ``bt_<name>`` on a CUDA table (any
    layout: the kernels share csrc/frontier.cuh), in place; ``extra`` are
    the layout's trailing int arguments before the stream. Returns the next
    ids array, whose cells past its count are left unwritten."""
    device = table[0].device
    _build.require_cuda(device, name)
    if tile_n % 32 or tile_n > FRONTIER_TILE_MAX:
        raise ValueError(
            f"kernel tile_n must be a multiple of 32 <= {FRONTIER_TILE_MAX}, got {tile_n}"
        )
    p, n = table[0].shape
    t_total = n // tile_n
    _build.check_fields(table, (p, n), device, name)
    _build.check_fields((ids,), (_ids_len(t_total, m),), device, "frontier ids")
    lib = _build.library()
    ids_out = torch.empty_like(ids)
    stripe_changed = torch.empty(t_total, dtype=torch.int32, device=device)
    stripe_last = torch.empty(t_total, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = getattr(lib, f"bt_{name}")(
            _build.pointers(table), ids.data_ptr(), ids_out.data_ptr(),
            stripe_changed.data_ptr(), stripe_last.data_ptr(), p, n, tile_n,
            t_total, m, *extra, _build.stream_of(device),
        )
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return ids_out


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
    check_frontier_step(table, tile_n, m)
    if table.cls.device.type == "cpu":
        return frontier_round_dense_torch(table, ids, tile_n, wrap, mode, m)
    return table, launch_frontier_step(
        "frontier_round_dense", table, ids, tile_n, m, int(wrap), int(mode == "lww")
    )


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
    from .packed import frontier_loop

    if tile_n is None:
        tile_n = frontier_tile_n(table.cls.shape[1])
    return frontier_loop(
        table, dirty, table.cls.shape[1] // tile_n, max_rounds, fuse,
        lambda m: lambda tbl, ids: frontier_round_dense(tbl, ids, tile_n, wrap, mode, m),
    )
