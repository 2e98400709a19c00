"""Ring/chain gossip rounds and the compacting dense frontier.

One gossip round on a ring is ``merge(merge(t, roll(t, +1)), roll(t, -1))``
with both neighbours taken from the pre-round table; a chain replaces the
missing neighbour at each end with an all-zero row that is still compared.
A lean round (reference mode) merges only the value keys (cls, khi, klo,
vid) and leaves writer, ctr and tick alone.

Each kernel sits beside its plain PyTorch version:

* ``ring_round`` (``csrc/ring_round.cu``) / ``ring_round_torch``: one round
  over the whole table, in place; ``ring_round_lean`` /
  ``ring_round_lean_torch`` the lean round.
* ``frontier_round_dense`` (``csrc/frontier_dense.cu``) /
  ``frontier_round_dense_torch``: ``m`` rounds over the active slot stripes
  only, in place, returning the next round's compact ids array; full or
  lean.
* ``frontier_shard_round`` (``csrc/frontier_shard.cu``) /
  ``frontier_shard_round_torch``: the same on one shard of a device mesh,
  given its neighbours' boundary rows, returning uncompacted per-round,
  per-stripe counts.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Columns are independent under ring gossip,
so every function here may update its table in place: the port keeps one
table allocation where the reference returned a fresh one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import _build
from .merge import TableState, lean_fields, lex_gt, priority_keys

# plain versions work on column blocks of at most this many entries per
# field, which bounds their temporaries at large tables
_PLAIN_BLOCK_ELEMS = 1 << 24

FRONTIER_TILE_MAX = 256

# the reference's TPU tiling constants: they decide WHICH route a lean or
# sharded sim takes (and so its bits), never the port's own tiling
_HALO = 8
_FULLP_MAX_ELEMS = 1 << 16

# beats(b_fields, a_fields) -> bool mask of entries where b strictly wins;
# the plain versions below take one, so every layout shares them
Beats = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], torch.Tensor]


def dense_beats(mode: str) -> Beats:
    """The dense layout's priority order under ``mode``."""
    return lambda b, a: lex_gt(
        priority_keys(TableState(*b), mode), priority_keys(TableState(*a), mode)
    )


def lean_beats(b: Sequence[torch.Tensor], a: Sequence[torch.Tensor]) -> torch.Tensor:
    """The lean order: the four value keys (cls, khi, klo, vid)."""
    return lex_gt(b, a)


def beats_of(nf: int, mode: str) -> Beats:
    """The order of a dense-family field tuple: 4 fields lean, 7 full."""
    return lean_beats if nf == 4 else dense_beats(mode)


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


# ------------------------------------------------------------ lean round


def lean_supported(p: int, n: int) -> bool:
    """Whether the reference takes its lean round at [p, n]
    (``ring_kernel.py:238``): its full-P lean tiling fits, or its halo
    variant (8-aligned P, at least two tiles). A semantic predicate here:
    where it is False a lean sim's rounds merge all seven fields, as the
    reference's do."""
    tile_n = _lean_tile_n(p, n)
    if p * tile_n <= _FULLP_MAX_ELEMS * 2 and n % tile_n == 0 and n % 128 == 0:
        return True
    return p % _HALO == 0 and p >= 2 * _HALO and n % 128 == 0


def _lean_tile_n(p: int, n: int) -> int:
    t = min(max(128, (_FULLP_MAX_ELEMS * 2) // p), n)
    while t > 128 and n % t:
        t -= 128
    return t if n % t == 0 else n


def ring_round_lean_torch(table: TableState, wrap: bool = True) -> Tuple[TableState, torch.Tensor]:
    """Plain version of one lean ring or chain round, in place on the four
    value keys. Returns (table, changed) as ``ring_round_torch``."""
    return table, rounds_torch(lean_fields(table), wrap, lean_beats)


def ring_round_lean(table: TableState, wrap: bool = True) -> Tuple[TableState, torch.Tensor]:
    """One lean ring or chain round, in place on (cls, khi, klo, vid): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. Any
    P, N >= 1; the sim takes it where ``lean_supported`` says the reference
    does."""
    device = table.cls.device
    if device.type == "cpu":
        return ring_round_lean_torch(table, wrap)
    _build.require_cuda(device, "ring_round_lean")
    keys = lean_fields(table)
    p, n = table.cls.shape
    _build.check_fields(keys, (p, n), device, "ring_round_lean")
    lib = _build.library()
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_ring_round_lean(
            _build.pointers(keys), count.data_ptr(), p, n, int(wrap), _build.stream_of(device)
        )
    _build.check(err, "ring_round_lean")
    _build.LAUNCHES["ring_round_lean"] += 1
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


def dense_frontier_available(p: int, n: int, lean: bool) -> bool:
    """Whether the reference runs its dense frontier at [p, n]
    (``frontier_tile_n_dense(p, n, lean) > 0``, ``ring_kernel.py:811``).
    A lean sim must take the frontier exactly where the reference does:
    the frontier merges four fields, the round loop it falls back to may
    merge seven."""
    if p % _HALO or n % 128:
        return False
    budget = _FULLP_MAX_ELEMS * (2 if lean else 1)
    start = (budget // max(p, 1)) // 128 * 128
    t = min(max(128, start), n)
    while t >= 128 and n % t:
        t -= 128
    return t >= 128 and n % t == 0 and p * t <= budget * 2


def dense_frontier_available_sharded(p: int, n: int, shards: int, lean: bool) -> bool:
    """The reference's test for its dense frontier on a mesh of ``shards``
    (``frontier_tile_n_dense_sharded(...) > 0``, ``ring_kernel.py:798``):
    P divides evenly, at least 8 rows per shard, 8-aligned, n % 128 == 0."""
    if shards <= 0 or p % shards:
        return False
    b = p // shards
    if b % _HALO or b < _HALO or n % 128:
        return False
    return dense_frontier_available(b, n, lean)


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
    m: int = 1, lean: bool = False,
) -> Tuple[TableState, torch.Tensor]:
    """Plain version of one compacting dense frontier step (see
    ``frontier_round_torch``), on the four value keys when ``lean``.
    Returns (table, next ids)."""
    fields = lean_fields(table) if lean else table
    return table, frontier_round_torch(fields, ids, tile_n, wrap, beats_of(len(fields), mode), m)


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
    m: int = 1, lean: bool = False,
) -> Tuple[TableState, torch.Tensor]:
    """One compacting frontier step (``m`` fused rounds), in place, on all
    seven fields or (``lean``) the four value keys: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. ``ids`` is
    [t_total + 2] for m = 1, [t_total + 3] for m > 1. Cells of the returned
    ids array past its count are left unwritten by the kernel."""
    if mode not in ("reference", "lww"):
        raise ValueError(f"unknown merge mode: {mode}")
    check_frontier_step(table, tile_n, m)
    if table.cls.device.type == "cpu":
        return frontier_round_dense_torch(table, ids, tile_n, wrap, mode, m, lean)
    fields = lean_fields(table) if lean else table
    return table, launch_frontier_step(
        "frontier_round_dense", fields, ids, tile_n, m, int(wrap), int(mode == "lww"),
        len(fields),
    )


def gossip_frontier_dense(
    table: TableState,
    dirty: torch.Tensor,
    wrap: bool,
    mode: str,
    max_rounds: int,
    fuse: int = 1,
    tile_n: Optional[int] = None,
    lean: bool = False,
) -> Tuple[TableState, int, int]:
    """Dense frontier convergence loop (ring/chain), in place: per round
    only stripes still changing are touched. ``dirty`` is a bool [t_total]
    seed. Returns (table, classic rounds, last_changed), bit-identical to
    the classic all-stripes loop (of lean rounds when ``lean``), also with
    ``fuse`` > 1, which runs FUSE rounds per step and reconstructs the
    exact classic round count. The host reads one small slice of the ids
    array per step."""
    from .packed import frontier_loop

    if tile_n is None:
        tile_n = frontier_tile_n(table.cls.shape[1])
    return frontier_loop(
        table, dirty, table.cls.shape[1] // tile_n, max_rounds, fuse,
        lambda m: lambda tbl, ids: frontier_round_dense(tbl, ids, tile_n, wrap, mode, m, lean),
    )


# ------------------------------------------ per-shard frontier (device mesh)


def frontier_shard_round_torch(
    fields: Sequence[torch.Tensor], tops: Sequence[torch.Tensor],
    bottoms: Sequence[torch.Tensor], ids: torch.Tensor, tile_n: int, beats: Beats,
    m: int = 1,
) -> torch.Tensor:
    """Plain version of one per-shard frontier step: ``m`` rounds on the
    stripes ``ids[:ids[t_total]]`` of the shard's [b, N] ``fields``, in
    place, each on the extended column (the [s, N] rows ``tops`` above,
    the shard, the [s, N] rows ``bottoms`` below) wrapped as a ring, as
    the reference's trapezoid does; m <= s keeps the shard's rows exact.
    Returns the per-round, per-stripe change counts of the shard's rows,
    int32 [m, t_total], zero for stripes not in ids."""
    b, n = fields[0].shape
    s = tops[0].shape[0]
    t_total = n // tile_n
    device = fields[0].device
    counts = torch.zeros((m, t_total), dtype=torch.int32, device=device)
    count = int(ids[t_total])
    if count == 0:
        return counts
    stripes = ids[:count].to(device=device, dtype=torch.int64)
    lanes = torch.arange(tile_n, device=device)
    per_block = max(1, _PLAIN_BLOCK_ELEMS // max((b + 2 * s) * tile_n, 1))
    for s0 in range(0, count, per_block):
        s1 = min(count, s0 + per_block)
        cols = (stripes[s0:s1, None] * tile_n + lanes).reshape(-1)
        ext = [
            torch.cat([t.index_select(1, cols), f.index_select(1, cols),
                       bo.index_select(1, cols)])
            for f, t, bo in zip(fields, tops, bottoms)
        ]
        for k in range(m):
            ext, gt1, gt2 = _round_masks(ext, True, beats)
            c = (gt1[s:s + b].sum(0) + gt2[s:s + b].sum(0)).reshape(s1 - s0, tile_n).sum(1)
            counts[k, stripes[s0:s1]] = c.to(torch.int32)
        for f, v in zip(fields, ext):
            f.index_copy_(1, cols, v[s:s + b])
    return counts


def frontier_shard_round(
    fields: Sequence[torch.Tensor], tops: Sequence[torch.Tensor],
    bottoms: Sequence[torch.Tensor], ids: torch.Tensor, tile_n: int, mode: str,
    m: int = 1, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One per-shard frontier step (see ``frontier_shard_round_torch``) on
    a shard's seven fields or (lean) its four value keys: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. ``tops`` and
    ``bottoms`` hold the neighbour shards' boundary rows, taken before
    any shard's step (zeros at a chain's ends). The kernel only reads
    them at m = 1 and m = 8 (one pipelined pass), the depths the loops
    send; another m uses them as scratch, so no caller may depend on
    their contents after the call. Returns the int32 [m, t_total]
    counts, in ``out`` when given (zeroed, on the shard's device: the
    shard's row of the mesh's fold buffer); the caller folds the shards'
    counts into the next ids array (``ops.packed.compact_counts``)."""
    if mode not in ("reference", "lww"):
        raise ValueError(f"unknown merge mode: {mode}")
    nf = len(fields)
    if nf not in (4, 7):
        raise ValueError(f"frontier_shard_round takes 4 or 7 fields per part, got {nf}")
    check_shard_step(fields, tops, bottoms, tile_n, m, m)
    if fields[0].device.type == "cpu":
        return plain_into(
            frontier_shard_round_torch(fields, tops, bottoms, ids, tile_n, beats_of(nf, mode), m),
            out)
    counts = shard_step_out(fields, out, m, tile_n, "frontier_shard_round")
    launch_shard_step("frontier_shard", fields, tops, bottoms, ids, tile_n, (counts,),
                      m, int(mode == "lww"), nf)
    _build.LAUNCHES["frontier_shard" if m == 1 else "frontier_shard fused"] += 1
    return counts


def check_shard_step(fields, tops, bottoms, tile_n: int, m: int, min_rows: int) -> None:
    """Raise unless a per-shard step of ``m`` rounds can run: ``tile_n``
    stripes the shard, and ``tops`` / ``bottoms`` hold one part each of at
    least ``min_rows`` boundary rows."""
    nf = len(fields)
    if len(tops) != nf or len(bottoms) != nf:
        raise ValueError(f"{nf} fields with {len(tops)} tops and {len(bottoms)} bottoms")
    check_frontier_step(fields, tile_n, m)
    s = tops[0].shape[0]
    if s < min_rows:
        raise ValueError(f"{m} fused rounds need {min_rows} boundary rows, got {s}")


def shard_step_out(fields, out: Optional[torch.Tensor], rows: int, tile_n: int,
                   what: str) -> torch.Tensor:
    """The int32 [rows, t_total] output a per-shard kernel stores or adds
    into: ``out``, a caller's zeroed buffer on the shard's device, or a new
    zeroed one."""
    shape = (rows, fields[0].shape[1] // tile_n)
    if out is None:
        return torch.zeros(shape, dtype=torch.int32, device=fields[0].device)
    _build.check_fields((out,), shape, fields[0].device, f"{what} out")
    return out


def plain_into(result: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """A plain per-shard step's result, copied into ``out`` when given."""
    return result if out is None else out.copy_(result)


def launch_shard_step(name: str, fields, tops, bottoms, ids: torch.Tensor, tile_n: int,
                      outs: Sequence[torch.Tensor], *ints: int) -> None:
    """Launch the per-shard kernel ``bt_<name>`` on a CUDA shard, in place.
    Every per-shard kernel takes (fields, tops, bottoms, ids, its output
    and scratch tensors ``outs``, the shard's rows b, the boundary rows s,
    n, tile_n, t_total, its own trailing ``ints``, the stream)."""
    device = fields[0].device
    _build.require_cuda(device, name)
    if tile_n % 32 or tile_n > FRONTIER_TILE_MAX:
        raise ValueError(
            f"kernel tile_n must be a multiple of 32 <= {FRONTIER_TILE_MAX}, got {tile_n}"
        )
    b, n = fields[0].shape
    s = tops[0].shape[0]
    t_total = n // tile_n
    _build.check_fields(fields, (b, n), device, name)
    _build.check_fields((*tops, *bottoms), (s, n), device, f"{name} boundary")
    if ids.device != device or ids.dtype != torch.int32 or ids.numel() < t_total + 2:
        raise ValueError(f"{name}: ids must be int32 [t_total + 2 or 3] on the shard")
    lib = _build.library()
    with torch.cuda.device(device):
        err = getattr(lib, f"bt_{name}")(
            _build.pointers(fields), _build.pointers(tops), _build.pointers(bottoms),
            ids.data_ptr(), *(t.data_ptr() for t in outs), b, s, n, tile_n, t_total, *ints,
            _build.stream_of(device),
        )
    _build.check(err, name)
