"""Packed 12 B/entry layout: the port of ``bullet_tpu.ops.packed``.

Reference-mode merge priority only reads the four value keys (cls, khi,
klo, vid); packing cls (3 bits) and vid (< 2^28) into one word
``cv = cls << 28 | vid`` gives a 3-array table

    khi, klo, cv : int32 [P, N]   -> 12 B/entry

so 1,024 peers x 2^20 slots take 12.9 GB. The merge order is
lexicographic over ``(cv >> 28, khi, klo, cv)`` == (cls, khi, klo, vid).
The helpers are generic over the field count, as the reference's are:
3 = packed ``(khi, klo, cv)``, 2 = rank ``(rank, cv)``, 1 = rank1.

Each kernel sits beside its plain PyTorch version:

* ``apply_flat_packed`` (``csrc/apply_packed.cu``) /
  ``apply_flat_packed_torch``: K pre-reduced ops, in place, win count;
* ``ring_round_packed`` / ``ring_multiround_packed`` /
  ``count_changes_round_packed`` (``csrc/packed_round.cu``) /
  ``packed_round_torch``: m in-place ring/chain rounds (m >= 8 as
  pipelined passes of 8 rounds, then single sweeps), or the count one
  round would make;
* ``reconcile_packed`` (``csrc/reconcile_packed.cu``) /
  ``reconcile_packed_torch``: every row becomes its column's join;
* ``frontier_round_packed`` (``csrc/frontier_packed.cu``) /
  ``frontier_round_packed_torch``: m rounds over the active stripes only,
  returning the next compact ids array;
* ``ring_window_packed`` (``csrc/window_packed.cu``) /
  ``ring_window_packed_torch``: m rounds as one radius-(m-1) window join
  plus a classic last round, returning the round-m residual;
* ``converge_columns_packed`` (``csrc/converge_columns.cu``) /
  ``converge_columns_packed_torch``: the dirty columns' fixed point in one
  pass (each column's join in every row), returning the rounds' depth;
* ``converge_graph_packed`` (``csrc/converge_graph.cu``) /
  ``converge_graph_packed_torch``: any neighbour matrix's rounds on the
  dirty columns in one pass, returning every round's count;
* on a device mesh, per shard: ``frontier_shard_round_packed``
  (``csrc/frontier_shard.cu``) / ``frontier_shard_round_torch`` with
  ``packed_beats``: m = 1 or 8 rounds on the active stripes, per-round
  counts; ``frontier_shard_window`` (``csrc/frontier_shard_window.cu``) /
  ``frontier_shard_window_torch``: m <= 63 rounds per boundary exchange,
  the window stats; each into its row of one [S, ...] buffer; and the
  fold of the shards' rows into the next ids array, one launch a step:
  ``compact_counts`` / ``compact_counts_torch`` and
  ``compact_counts_window`` / ``compact_counts_window_torch``
  (``csrc/compact_counts.cu``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Every kernel is instantiated for the three
field counts (csrc/lexmax.cuh: ``PackedEntry``, ``RankEntry``,
``Rank1Entry``). The kernels update the table in place; the port keeps
one table allocation where the reference donated and re-bound buffers.

The compacting frontier loops carry a compact ids array instead of
per-stripe dirty flags; each frontier step produces the next one. Layout
([t_total + 2] int32, [t_total + 3] for fused steps):

* ``[0, count)``   dirty stripe ids, ascending
* ``[t_total]``    count
* ``[t_total + 1]`` total entries changed in the step that produced it
* ``[t_total + 2]`` max over stripes of the last round that changed the
  stripe (fused steps only)
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..parallel.mesh import ShardedTable
from ..utils import observe
from .merge import TableState, lex_gt
from .ring_kernel import (
    _PLAIN_BLOCK_ELEMS,
    _lexmax,
    _round_masks,
    check_frontier_step,
    check_shard_step,
    frontier_round_torch,
    frontier_shard_round_torch,
    frontier_tile_n,
    launch_frontier_step,
    launch_shard_step,
    plain_into,
    rounds_torch,
    shard_step_out,
)

CV_SHIFT = 28
VID_MASK = (1 << CV_SHIFT) - 1
MAX_VID = VID_MASK  # interner capacity in packed mode: 2^28 distinct values

# rounds fused per frontier step on the card
STRIPE_FUSE = 8


class PackedTable(NamedTuple):
    """Reference-mode replica tables at 12 B/entry: int32 [P, N] each."""

    khi: torch.Tensor
    klo: torch.Tensor
    cv: torch.Tensor  # cls << 28 | vid


def init_packed(num_peers: int, capacity: int, device) -> PackedTable:
    """All-absent packed table; three distinct allocations (the kernels
    update fields in place)."""
    return PackedTable(*(
        torch.zeros((num_peers, capacity), dtype=torch.int32, device=device)
        for _ in range(3)
    ))


def pack_cv(cls, vid):
    return (cls << CV_SHIFT) | vid


def pack_table(t: TableState) -> PackedTable:
    """Dense -> packed (drops writer/ctr/tick)."""
    return PackedTable(t.khi.clone(), t.klo.clone(), pack_cv(t.cls, t.vid))


def unpack_table(pt: PackedTable) -> TableState:
    """Packed -> dense with zeroed metadata."""
    z = torch.zeros_like(pt.cv)
    return TableState(
        cls=pt.cv >> CV_SHIFT, khi=pt.khi.clone(), klo=pt.klo.clone(),
        vid=pt.cv & VID_MASK, writer=z, ctr=z.clone(), tick=z.clone(),
    )


def packed_keys(khi, klo, cv):
    """(cls, khi, klo, vid) as a 4-key lex chain on packed fields."""
    return (cv >> CV_SHIFT, khi, klo, cv)


def table_keys(fields: Sequence[torch.Tensor]):
    """Lex key chain for a packed-family field tuple, by its length: 3 =
    packed (khi, klo, cv) -> (cls, khi, klo, vid); 2 = rank (rank, cv) and
    1 = rank1 (rank) -> the rank alone (distinct vids have distinct ranks,
    so the cv tiebreak can never fire)."""
    if len(fields) <= 2:
        return (fields[0],)
    return packed_keys(*fields)


def op_present(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """Live-op guard for a packed-family field tuple: rank1's single field
    is the rank (0 = absent); otherwise the last field is cv, whose top
    bits carry cls (0 = absent)."""
    if len(vals) == 1:
        return vals[0] > 0
    return (vals[-1] >> CV_SHIFT) > 0


def packed_beats(b: Sequence[torch.Tensor], a: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mask of entries where field tuple ``b`` strictly beats ``a``."""
    return lex_gt(table_keys(b), table_keys(a))


def merge_packed_torch(a, b) -> Tuple[object, torch.Tensor]:
    """Plain twin of the reference's ``merge_packed_xla``: winner-select
    over packed-family tables + the count of entries ``b`` won (int32)."""
    take_b = packed_beats(b, a)
    merged = type(a)(*(torch.where(take_b, fb, fa) for fa, fb in zip(a, b)))
    return merged, take_b.sum(dtype=torch.int64).to(torch.int32)


def _fields_checked(table, what: str) -> Tuple[int, int]:
    """Raise unless ``table`` is a contiguous int32 CUDA table of a
    packed-family layout (1, 2 or 3 fields); returns (P, N)."""
    if len(table) not in (1, 2, 3):
        raise ValueError(f"{what}: kernels take 1-, 2- or 3-field tables, got {len(table)}")
    device = table[0].device
    _build.require_cuda(device, what)
    p, n = table[0].shape
    _build.check_fields(table, (p, n), device, what)
    return p, n


# ---------------------------------------------------------------- op apply


def reduce_flat_ops(peer, slot, cls, khi, klo, vid):
    """Host-side lattice pre-reduction: the (cls, khi, klo, vid)-max op per
    (peer, slot), sorted by (peer, slot), as (peer, slot, khi, klo, cv)
    int32 arrays; None when no op is live (cls > 0).

    The native radix pass (``native.reduce_flat_ops``) runs when the
    library is available; this numpy body is its bit-identical fallback.
    One argsort groups the ops by a fused (peer, slot) int64; the group
    max falls out of two segmented ``maximum.reduceat`` passes over fused
    keys k1 = cls * 2^32 + khi_u (priority (cls, khi)) and
    k2 = klo_u * 2^28 + vid (priority (klo, vid)), with the bias-mapped
    unsigned halves recombining order-exactly."""
    from .. import native

    fast = native.reduce_flat_ops(peer, slot, cls, khi, klo, vid, 0, 0, CV_SHIFT, VID_MASK)
    if fast is not NotImplemented:
        return fast

    keep = cls > 0
    peer, slot, cls, khi, klo, vid = (a[keep] for a in (peer, slot, cls, khi, klo, vid))
    if peer.size == 0:
        return None
    bias = np.int64(1) << 31
    pslot = (peer.astype(np.int64) << 32) | slot.astype(np.int64)
    k1 = (cls.astype(np.int64) << 32) | (khi.astype(np.int64) + bias)
    k2 = ((klo.astype(np.int64) + bias) << CV_SHIFT) | vid.astype(np.int64)
    order = np.argsort(pslot)  # the winner needs no row identity: any sort kind
    ps = pslot[order]
    first = np.empty(ps.size, dtype=bool)
    first[0] = True
    np.not_equal(ps[1:], ps[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    k1s = k1[order]
    m1 = np.maximum.reduceat(k1s, starts)
    sizes = np.diff(np.concatenate((starts, [ps.size])))
    k2s = np.where(k1s == np.repeat(m1, sizes), k2[order], np.int64(-1))
    m2 = np.maximum.reduceat(k2s, starts)
    cls_w = m1 >> 32
    khi_w = ((m1 & np.int64(0xFFFFFFFF)) - bias).astype(np.int32)
    klo_w = ((m2 >> CV_SHIFT) - bias).astype(np.int32)
    cv = ((cls_w << CV_SHIFT) | (m2 & np.int64(VID_MASK))).astype(np.int32)
    keys = ps[starts]
    peer_w = (keys >> 32).astype(np.int32)
    slot_w = (keys & np.int64(0xFFFFFFFF)).astype(np.int32)
    return peer_w, slot_w, khi_w, klo_w, cv


def apply_flat_packed_torch(table, ops: torch.Tensor) -> Tuple[object, torch.Tensor]:
    """Plain version of the flat apply, in place: ``ops`` is [2 + nf, K]
    int32 (rows peer, slot, then the table's fields) with unique
    (peer, slot) pairs. An op lands iff it is live (``op_present``) and
    strictly beats the entry; ops outside the table are dropped. Returns
    (table, the count of ops that landed, int32)."""
    p, n = table[0].shape
    peer, slot = ops[0].to(torch.int64), ops[1].to(torch.int64)
    inside = (peer >= 0) & (peer < p) & (slot >= 0) & (slot < n)
    peer, slot, vals = peer[inside], slot[inside], ops[2:, inside]
    cur = [f[peer, slot] for f in table]
    win = packed_beats(list(vals), cur) & op_present(list(vals))
    for f, v, c in zip(table, vals, cur):
        f[peer, slot] = torch.where(win, v, c)
    return table, win.sum(dtype=torch.int64).to(torch.int32)


def apply_flat_packed(table, ops: torch.Tensor) -> Tuple[object, torch.Tensor]:
    """Apply K pre-reduced ops, stacked as [2 + nf, K] int32 rows peer,
    slot, then the table's fields (``reduce_flat_ops`` or
    ``reduce_flat_ops_rank`` output), in place: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns (table, applied
    count)."""
    device = table[0].device
    if device.type == "cpu":
        return apply_flat_packed_torch(table, ops)
    p, n = _fields_checked(table, "apply_flat_packed")
    k = ops.shape[1] if ops.dim() == 2 else 0
    _build.check_fields((ops,), (2 + len(table), k), device, "apply ops")
    count = torch.zeros(1, dtype=torch.int32, device=device)
    if k == 0:
        return table, count[0]
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_apply_packed(
            _build.pointers(table), ops.data_ptr(), k, p, n, count.data_ptr(),
            len(table), _build.stream_of(device),
        )
    _build.check(err, "apply_flat_packed")
    _build.LAUNCHES["apply_packed"] += 1
    return table, count[0]


# ------------------------------------------------------------------ rounds


def packed_round_torch(
    table, wrap: bool, m: int = 1, count_only: bool = False
) -> Tuple[object, torch.Tensor]:
    """Plain version of ``m`` ring (wrap) or chain rounds on a packed-family
    table, in place, or with ``count_only`` the count one round would make
    with nothing written. Returns (table, changed count summed over the
    rounds, int32)."""
    return table, rounds_torch(table, wrap, packed_beats, m, store=not count_only)


def _packed_round(table, wrap: bool, m: int, count_only: bool):
    if m < 1 or (count_only and m != 1):
        raise ValueError(f"bad round request m={m} count_only={count_only}")
    device = table[0].device
    if device.type == "cpu":
        return packed_round_torch(table, wrap, m, count_only)
    p, n = _fields_checked(table, "packed_round")
    lib = _build.library()
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_packed_round(
            _build.pointers(table), count.data_ptr(), p, n, m, int(wrap),
            int(count_only), len(table), _build.stream_of(device),
        )
    _build.check(err, "packed_round")
    _build.LAUNCHES["packed_round" if m == 1 else "packed_round fused"] += 1
    return table, count[0]


def ring_round_packed(table, wrap: bool = True) -> Tuple[object, torch.Tensor]:
    """One ring (wrap) or chain round, in place, + changed count. Any P, N."""
    return _packed_round(table, wrap, 1, False)


def ring_multiround_packed(table, wrap: bool, m: int) -> Tuple[object, torch.Tensor]:
    """``m`` rounds in one call, in place, + the count summed over them: on
    the card m // 8 pipelined passes of 8 rounds (one read and one write of
    the table each), then m % 8 single sweeps."""
    return _packed_round(table, wrap, m, False)


def count_changes_round_packed(table, wrap: bool) -> torch.Tensor:
    """Entries one more ring/chain round would change; writes nothing."""
    return _packed_round(table, wrap, 1, True)[1]


def gossip_round_ring_packed(table):
    """Plain twin of the reference's ring round (in place, + count)."""
    return packed_round_torch(table, True)


def gossip_round_chain_packed(table):
    """Plain twin of the reference's chain round (in place, + count)."""
    return packed_round_torch(table, False)


def gossip_round_mesh_packed(table) -> Tuple[object, torch.Tensor]:
    """Full mesh: ceil(log2 P) roll-doubling merges (one round reaches the
    fixed point); returns a new table and the summed win count."""
    p = table[0].shape[0]
    total = torch.zeros((), dtype=torch.int32, device=table[0].device)
    for k in range(max(1, (p - 1).bit_length())):
        rolled = type(table)(*(torch.roll(f, 1 << k, 0) for f in table))
        table, c = merge_packed_torch(table, rolled)
        total = total + c
    return table, total


def gossip_round_generic_packed(table, neighbors) -> Tuple[object, torch.Tensor]:
    """Any topology: merge each neighbour column of ``neighbors`` [P, D]
    (-1 = none) in turn, every merge reading the partly merged table, as
    the reference's loop does; returns a new table and the summed count."""
    nb = torch.as_tensor(np.asarray(neighbors), dtype=torch.int64, device=table[0].device)
    total = torch.zeros((), dtype=torch.int32, device=table[0].device)
    for k in range(nb.shape[1]):
        idx = nb[:, k]
        valid = (idx >= 0)[:, None]
        safe = idx.clamp(min=0)
        gathered = type(table)(*(torch.where(valid, f[safe], 0) for f in table))
        table, c = merge_packed_torch(table, gathered)
        total = total + c
    return table, total


def gossip_round_packed(table, topology) -> Tuple[object, torch.Tensor]:
    """One packed round for any topology: ring/chain on ``ring_round_packed``
    (the kernel on the card, in place), mesh and generic topologies as
    plain PyTorch merges. A ``ShardedTable`` takes the explicit exchanges
    of ``parallel/shardmap_gossip.py`` (the reference's ``mesh=``): the
    ring/chain exchange, the mesh's doubling, the generic gathers (a star's
    too), each bit-identical to the unsharded round, counts included."""
    if isinstance(table, ShardedTable):
        from ..parallel import shardmap_gossip as sg

        if topology.kind in ("ring", "chain"):
            return sg.ring_round_shardmap_packed(table, topology.kind == "ring")
        if topology.kind == "mesh":
            return sg.mesh_round_shardmap_packed(table)
        return sg.generic_round_shardmap_packed(table, topology.neighbors)
    if topology.kind in ("ring", "chain"):
        return ring_round_packed(table, topology.kind == "ring")
    if topology.kind == "mesh":
        return gossip_round_mesh_packed(table)
    return gossip_round_generic_packed(table, topology.neighbors)


def gossip_until_converged_packed(table, topology, max_rounds: int, spmd: bool = False):
    """Whole-table round loop: rounds until one changes nothing or
    ``max_rounds``; the host reads one count per round. ``spmd`` (a
    ``ShardedTable`` under ``use_shard_map``, the reference's
    ``spmd_mesh``) takes ``shardmap_round_packed``, whose star round is the
    hub reduce. Returns (table, rounds executed, last round's changed
    count; 1 if no round ran). The span ``loop`` counts its ``steps``
    (rounds) and ``waits`` (the count reads, each a ``loop.wait``)."""
    round_fn = gossip_round_packed
    if spmd:
        from ..parallel.shardmap_gossip import shardmap_round_packed as round_fn
    rounds, last_changed = 0, 1
    with observe.span("loop") as sp:
        while rounds < max_rounds and last_changed > 0:
            table, changed = round_fn(table, topology)
            with observe.span("loop.wait"):
                last_changed = int(changed)
            rounds += 1
        sp.set(steps=rounds, waits=rounds)
    return table, rounds, last_changed


# ------------------------------------------------------------ window join


def _window_chain(m: int):
    """Shift schedule whose 3-way joins grow the window radius to exactly
    ``m`` in O(log m) steps: from radius r, joining the window with copies
    of itself shifted by +-s covers radius r + s for any s <= 2r + 1, so
    the greedy s = min(m - r, 2r + 1) lands on m exactly."""
    steps = []
    r = 0
    while r < m:
        s = min(m - r, 2 * r + 1)
        steps.append(s)
        r += s
    return steps


def _window_shifted(vals: List[torch.Tensor], s: int, wrap: bool):
    """Row p of the result is row p - s (wrapped on a ring). A chain clamps
    the rows that fall off an end to the edge row, whose accumulated window
    is the edge-clipped one (zero-filling would lose that coverage)."""
    p = vals[0].shape[0]
    out = []
    for f in vals:
        rolled = torch.roll(f, s, 0)
        if not wrap:
            if s > 0:
                rolled[: min(s, p)] = f[0:1]
            else:
                rolled[max(p + s, 0):] = f[p - 1:]
        out.append(rolled)
    return out


def ring_window_packed_torch(table, wrap: bool, m: int) -> Tuple[object, torch.Tensor]:
    """Plain twin of the reference's ``ring_window_packed_xla``: ``m`` ring
    (wrap) or chain rounds as a radius-(m-1) window join (O(log m)
    roll+join steps) finished by one classic round, in place, on column
    blocks (columns are independent), which bounds the temporaries at large
    tables. Bit-identical to m sequential rounds; the returned count
    (int32) is the classic round-m residual."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    p, n = table[0].shape
    width = max(1, _PLAIN_BLOCK_ELEMS // max(p, 1))
    steps = _window_chain(m - 1)
    total = torch.zeros((), dtype=torch.int64, device=table[0].device)
    for c0 in range(0, n, width):
        vals = [f[:, c0:c0 + width] for f in table]
        for s in steps:
            vals, _ = _lexmax(vals, _window_shifted(vals, s, wrap), packed_beats)
            vals, _ = _lexmax(vals, _window_shifted(vals, -s, wrap), packed_beats)
        vals, gt1, gt2 = _round_masks(vals, wrap, packed_beats)
        total += gt1.sum() + gt2.sum()
        for f, v in zip(table, vals):
            f[:, c0:c0 + width] = v
    return table, total.to(torch.int32)


def _check_slabs(tops, bottoms, m: int, n: int) -> None:
    """Raise unless every slab is [m, n]: the window of m rounds reads m
    rows on each side."""
    for slab in (*tops, *bottoms):
        if tuple(slab.shape) != (m, n):
            raise ValueError(f"a window of {m} rounds needs [{m}, {n}] slabs, got "
                             f"{tuple(slab.shape)}")


def ring_window_shard_torch(fields, tops, bottoms, m: int):
    """Plain twin of the reference's per-device window body
    (``_window_block_packed``): ``m`` rounds of a shard's [b, n] rows
    given the m rows above (``tops``) and below (``bottoms``) it, taken
    before the call. The extended column [m slab | b rows | m slab] joins
    to radius m - 1 (``_window_chain``'s doubling steps as line shifts:
    rows from past its ends are the all-zero entry), then runs the last
    round classically, on column blocks (columns are independent), which
    bounds the temporaries. The slabs are exactly m deep, so the shard's
    rows are exact; a chain's zeroed end slabs are its absent neighbours.
    Returns (the center rows' new values, a list of [b, n] tensors; the
    round-m residual of the center rows as int32). Reads only."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    b, n = fields[0].shape
    _check_slabs(tops, bottoms, m, n)
    steps = _window_chain(m - 1)

    def shifted(vals, s):
        return [_shift_line(v, s, 0) for v in vals]

    out = [torch.empty_like(f) for f in fields]
    count = torch.zeros((), dtype=torch.int64, device=fields[0].device)
    width = max(1, _PLAIN_BLOCK_ELEMS // (b + 2 * m))
    for c0 in range(0, n, width):
        cols = slice(c0, c0 + width)
        vals = [torch.cat([t[:, cols], x[:, cols], bo[:, cols]])
                for x, t, bo in zip(fields, tops, bottoms)]
        for s in steps:
            vals, _ = _lexmax(vals, shifted(vals, s), packed_beats)
            vals, _ = _lexmax(vals, shifted(vals, -s), packed_beats)
        # the classic last round (its down neighbour read from m1, as the
        # reference's: the same values and counts as the pre-round rows give)
        m1, gt1 = _lexmax(vals, shifted(vals, 1), packed_beats)
        m2, gt2 = _lexmax(m1, shifted(m1, -1), packed_beats)
        count += gt1[m:m + b].sum() + gt2[m:m + b].sum()
        for o, v in zip(out, m2):
            o[:, cols] = v[m:m + b]
    return out, count.to(torch.int32)


# the extended form's clip flags: the center's first (last) row is a
# chain's top (bottom) edge, with no slab on that side
CLIP_TOP, CLIP_BOTTOM = 1, 2


def window_rows(nf: int, device) -> int:
    """The most extended rows one launch of the window kernel takes at nf
    fields: two planes of one column in a block's shared memory."""
    lib = _build.library()
    with torch.cuda.device(device):
        return int(lib.bt_window_rows(nf))


def _window_launch(fields, tops, bottoms, m: int, clip: int, key: str) -> torch.Tensor:
    """One launch of the window kernel's extended form on CUDA ``fields``
    (the center rows, in place) between ``tops`` and ``bottoms`` (row
    tensors, or None for no slab); ``key`` names the launch count.
    Returns the center rows' round-m residual (int32 [1])."""
    device = fields[0].device
    b, n = fields[0].shape
    ht = tops[0].shape[0] if tops is not None else 0
    hb = bottoms[0].shape[0] if bottoms is not None else 0
    _build.check_fields(fields, (b, n), device, "window")
    for slab, rows in ((tops, ht), (bottoms, hb)):
        if slab is not None:
            _build.check_fields(slab, (rows, n), device, "window slab")
    lib = _build.library()
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_window_shard_packed(
            _build.pointers(fields), _build.pointers(tops) if tops is not None else None,
            _build.pointers(bottoms) if bottoms is not None else None, count.data_ptr(),
            b, n, m, ht, hb, clip, len(fields), _build.stream_of(device),
        )
    _build.check(err, "window")
    _build.LAUNCHES[key] += 1
    return count


def window_row_tiles(fields, m: int, rows: int, launch: Callable, wrap: bool = False,
                     tops=None, bottoms=None) -> torch.Tensor:
    """``m`` rounds on a column taller than one launch takes, as row tiles
    of the window kernel's extended form: each tile of at most rows - 2 m
    center rows between m-row slabs of the rows around it, all copied from
    the pre-call rows before the first launch, so no tile reads a row that
    another has written. The rows around ``fields`` [b, n] are ``tops`` and
    ``bottoms`` (the shard form, m rows each) or, without them, the
    table's own rows wrapped (a ring) or clamped to its edge rows (a chain:
    the edge row's window is the clipped one; the chain's edge tiles clip
    instead). ``launch(fields, tops, bottoms, m, clip)`` runs one tile in
    place and returns its count. Returns the summed count (int64)."""
    b = fields[0].shape[0]
    tile = rows - 2 * m
    if tile < 1:
        raise ValueError(f"a tile of {rows} rows cannot hold the slabs of {m} rounds")
    device = fields[0].device

    def virtual(lo: int, hi: int):
        """Copies of the rows [lo, hi) around and of the center."""
        if tops is not None:
            parts = []
            if lo < 0:
                parts.append([t[m + lo:m + min(hi, 0)] for t in tops])
            if max(lo, 0) < min(hi, b):
                parts.append([f[max(lo, 0):min(hi, b)] for f in fields])
            if hi > b:
                parts.append([t[max(lo, b) - b:hi - b] for t in bottoms])
            return [torch.cat([part[i] for part in parts]) for i in range(len(fields))]
        idx = torch.arange(lo, hi, device=device)
        idx = idx % b if wrap else idx.clamp(0, b - 1)
        return [f.index_select(0, idx) for f in fields]

    plan = []
    for t0 in range(0, b, tile):
        t1 = min(t0 + tile, b)
        clip = 0
        if tops is None and not wrap and t0 == 0:
            clip, top = clip | CLIP_TOP, None
        else:
            top = virtual(t0 - m, t0)
        if tops is None and not wrap and t1 == b:
            clip, bottom = clip | CLIP_BOTTOM, None
        else:
            bottom = virtual(t1, t1 + m)
        plan.append((t0, t1, top, bottom, clip))
    total = torch.zeros((), dtype=torch.int64, device=device)
    for t0, t1, top, bottom, clip in plan:
        total += launch([f[t0:t1] for f in fields], top, bottom, m, clip)[0]
    return total


def window_tiled_passes(fields, wrap: bool, m: int, rows: int, launch: Callable):
    """``m`` ring or chain rounds of a table taller than one launch takes
    (``rows``), in place: passes of at most rows / 4 rounds (so a tile's
    slabs take at most half its rows), each as ``window_row_tiles``.
    Returns the last pass's count: the round-m residual (int64)."""
    left = m
    while left:
        depth = min(left, max(1, rows // 4))
        total = window_row_tiles(fields, depth, rows, launch, wrap=wrap)
        left -= depth
    return total


def ring_window_packed(table, wrap: bool, m: int) -> Tuple[object, torch.Tensor]:
    """``m`` ring or chain rounds as one window join, in place: the CUDA
    kernel for CUDA tensors (one pass that reads and writes each entry
    once, where a column fits one launch; taller tables as row tiles, in
    passes of at most rows / 4 rounds), the plain version for CPU
    tensors. Returns (table, the classic round-m residual). Any P, N >= 1
    and m >= 1."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    device = table[0].device
    if device.type == "cpu":
        return ring_window_packed_torch(table, wrap, m)
    p, n = _fields_checked(table, "ring_window_packed")
    rows = window_rows(len(table), device)
    if p <= rows:
        lib = _build.library()
        count = torch.zeros(1, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            err = lib.bt_window_packed(_build.pointers(table), count.data_ptr(), p, n, m,
                                       int(wrap), len(table), _build.stream_of(device))
        _build.check(err, "ring_window_packed")
        _build.LAUNCHES["window_packed"] += 1
        return table, count[0]

    def launch(fields, tops, bottoms, depth, clip):
        return _window_launch(fields, tops, bottoms, depth, clip, "window_packed")

    return table, window_tiled_passes(list(table), wrap, m, rows, launch).to(torch.int32)


def ring_window_shard_packed(fields, tops, bottoms, m: int) -> torch.Tensor:
    """``m`` rounds of a shard's [b, n] rows between the m-row slabs of its
    neighbours (``ring_window_shard_torch``'s function), in place: the
    window kernel's extended form for CUDA tensors (a shard whose extended
    column is taller than one launch takes as row tiles), the plain version
    for CPU tensors. Returns the center rows' round-m residual (int32)."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    device = fields[0].device
    if device.type == "cpu":
        out, count = ring_window_shard_torch(fields, tops, bottoms, m)
        for f, o in zip(fields, out):
            f.copy_(o)
        return count
    b, n = _fields_checked(fields, "ring_window_shard_packed")
    _check_slabs(tops, bottoms, m, n)
    rows = window_rows(len(fields), device)
    if b + 2 * m <= rows:
        return _window_launch(list(fields), list(tops), list(bottoms), m, 0, "window_shard")[0]

    def launch(center, top, bottom, depth, clip):
        return _window_launch(center, top, bottom, depth, clip, "window_shard")

    total = window_row_tiles(list(fields), m, rows, launch, tops=list(tops),
                             bottoms=list(bottoms))
    return total.to(torch.int32)


# --------------------------------------------------------- direct reconcile


def reconcile_packed_torch(table):
    """Plain twin of the reference's ``reconcile_packed_xla``: ceil(log2 P)
    roll-doubling joins (at least one), after which every row holds the
    join of its whole column; in place, on column blocks (columns are
    independent), which bounds the temporaries at large tables."""
    p, n = table[0].shape
    width = max(1, _PLAIN_BLOCK_ELEMS // max(p, 1))
    for c0 in range(0, n, width):
        rows = type(table)(*(f[:, c0:c0 + width] for f in table))
        for k in range(max(1, (p - 1).bit_length())):
            rolled = type(table)(*(torch.roll(f, 1 << k, 0) for f in rows))
            rows, _ = merge_packed_torch(rows, rolled)
        for f, r in zip(table, rows):
            f[:, c0:c0 + width] = r
    return table


def reconcile_packed(table):
    """Direct reconcile: every row becomes its column's join. The CUDA
    kernel (each column's lexmax, written to every row, in place) for CUDA
    tensors; the doubling plain version for CPU tensors."""
    device = table[0].device
    if device.type == "cpu":
        return reconcile_packed_torch(table)
    p, n = _fields_checked(table, "reconcile_packed")
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_reconcile_packed(
            _build.pointers(table), p, n, len(table), _build.stream_of(device)
        )
    _build.check(err, "reconcile_packed")
    _build.LAUNCHES["reconcile_packed"] += 1
    return table


# ------------------------------------------------- frontier convergence


def frontier_round_packed_torch(table, ids, tile_n: int, wrap: bool, m: int = 1):
    """Plain version of one compacting packed frontier step, in place.
    Returns (table, next ids)."""
    return table, frontier_round_torch(table, ids, tile_n, wrap, packed_beats, m)


def frontier_round_packed(table, ids, tile_n: int, wrap: bool, m: int = 1):
    """One compacting frontier step (``m`` fused rounds) on a packed table,
    in place: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``ids`` is [t_total + 2] for m = 1, [t_total + 3] for m > 1.
    Cells of the returned ids array past its count are left unwritten by
    the kernel."""
    check_frontier_step(table, tile_n, m)
    if table[0].device.type == "cpu":
        return frontier_round_packed_torch(table, ids, tile_n, wrap, m)
    _fields_checked(table, "frontier_round_packed")
    return table, launch_frontier_step(
        "frontier_round_packed", table, ids, tile_n, m, int(wrap), len(table)
    )


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


def _wrap_int32(x: int) -> int:
    """A Python int wrapped like an int32 sum."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _ids_out(out: Optional[torch.Tensor], length: int, device, what: str) -> torch.Tensor:
    """The first ``length`` cells of ``out``, a caller's int32 ids buffer on
    ``device`` (a new one when None)."""
    if out is None:
        return torch.empty(length, dtype=torch.int32, device=device)
    if (out.dtype != torch.int32 or out.device != device or out.dim() != 1
            or out.numel() < length or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be int32 [>= {length}] on {device}")
    return out[:length]


def compact_counts_torch(counts: torch.Tensor, out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of the count fold and compaction: the S shards' int32
    [S, m, t_total] per-round, per-stripe change counts, summed over the
    shards (wrapping like the reference's int32 psum) -> the next ids array
    (in ``out`` when given): the stripes whose round-m count is > 0,
    ascending; their count; the total of every count (wrapping like int32);
    for m > 1 the max over stripes of the last round that changed it. Cells
    past the count are zero. Zeroes ``counts``, as the kernel does."""
    _, m, t_total = counts.shape
    c = counts.to(torch.int64).sum(0).to(torch.int32).to(torch.int64)
    counts.zero_()
    rounds = torch.arange(1, m + 1, device=counts.device)[:, None]
    last = torch.where(c > 0, rounds, 0).amax(0)
    keep = torch.nonzero(last == m).flatten()
    ids = _ids_out(out, t_total + (3 if m > 1 else 2), counts.device, "compact_counts")
    ids.zero_()
    ids[: keep.numel()] = keep.to(torch.int32)
    ids[t_total] = keep.numel()
    ids[t_total + 1] = _wrap_int32(int(c.sum()))
    if m > 1:
        ids[t_total + 2] = int(last.max()) if t_total else 0
    return ids


def compact_counts(counts: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The count fold and compaction (see ``compact_counts_torch``) of the
    shards' [S, m, t_total] counts, one launch: the CUDA kernel
    (``csrc/compact_counts.cu``, one block, which zeroes the counts as it
    reads them) for a CUDA tensor, the plain version for a CPU tensor. The
    port of the reference's psum over the shards and its
    ``compact_counts_packed`` (m = 1) and
    ``compact_counts_multiround_packed`` (m > 1). ``out``: an int32 ids
    buffer of at least t_total + 3 cells on the same device, which must not
    be the ids array the shards' step read (a loop ping-pongs two); the
    result is its first t_total + 2 (m = 1) or + 3 cells. Cells of the
    result past its count are left unwritten by the kernel."""
    if counts.dim() != 3 or counts.dtype != torch.int32 or counts.shape[0] < 1:
        raise ValueError("compact_counts takes int32 [S >= 1, m, t_total] counts")
    if counts.device.type == "cpu":
        return compact_counts_torch(counts, out)
    device = counts.device
    _build.require_cuda(device, "compact_counts")
    shards, m, t_total = counts.shape
    _build.check_fields((counts,), (shards, m, t_total), device, "compact_counts")
    ids = _ids_out(out, t_total + (3 if m > 1 else 2), device, "compact_counts")
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_compact_counts(
            counts.data_ptr(), ids.data_ptr(), shards, m, t_total, _build.stream_of(device)
        )
    _build.check(err, "compact_counts")
    _build.LAUNCHES["compact_counts" if m == 1 else "compact_counts fused"] += 1
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
    change count. Returns (table, classic rounds, last_changed).

    The span ``loop`` counts the ``steps`` launched, the ``stripe_steps``
    (each step's stripe count, summed) and the ``waits``, each a span
    ``loop.wait``: the host blocked on the device for the ids' tail; its
    ``columns`` (those the column pass settles) are 0."""
    with observe.span("loop") as sp:
        ids = torch.cat([
            frontier_ids_compact(dirty, t_total),
            torch.zeros(1, dtype=torch.int32, device=dirty.device),
        ])
        with observe.span("loop.wait"):
            count, changed, _ = ids[t_total:].tolist()
        rounds_done = 0
        last_change = -1
        steps = stripe_steps = 0
        while count > 0 and rounds_done + fuse < max_rounds:
            steps += 1
            stripe_steps += count
            table, ids = roundm_fn(table, ids)
            with observe.span("loop.wait"):
                count, changed, max_last = ids[t_total:].tolist()
            if max_last > 0:
                last_change = rounds_done + max_last
            rounds_done += fuse

        ids = ids[: t_total + 2]
        while count > 0 and rounds_done < max_rounds:
            steps += 1
            stripe_steps += count
            table, ids = round1_fn(table, ids)
            with observe.span("loop.wait"):
                count, changed = ids[t_total:].tolist()
            if changed > 0:
                last_change = rounds_done + 1
            rounds_done += 1
        sp.set(steps=steps, stripe_steps=stripe_steps, waits=steps + 1, columns=0)
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


def frontier_loop(
    table, dirty: torch.Tensor, t_total: int, max_rounds: int, fuse: int,
    step: Callable[[int], Callable],
) -> Tuple[object, int, int]:
    """Frontier convergence shared by the layouts: ``step(m)`` gives the
    layout's frontier step of m rounds. ``fuse`` > 1 runs the fused loop;
    otherwise one round per step until the frontier empties or
    ``max_rounds``. Returns (table, classic rounds, last_changed), the
    latter 0 iff the frontier is empty at exit. Either loop is the span
    ``loop`` (see ``frontier_fused_loop``)."""
    if fuse > 1:
        return frontier_fused_loop(table, dirty, t_total, max_rounds, fuse, step(1), step(fuse))
    round1 = step(1)
    with observe.span("loop") as sp:
        ids = frontier_ids_compact(dirty, t_total)
        rounds = stripe_steps = 0
        with observe.span("loop.wait"):
            count = int(ids[t_total])
        while count > 0 and rounds < max_rounds:
            stripe_steps += count
            table, ids = round1(table, ids)
            with observe.span("loop.wait"):
                count = int(ids[t_total])
            rounds += 1
        sp.set(steps=rounds, stripe_steps=stripe_steps, waits=rounds + 1, columns=0)
    last_changed = 0 if count == 0 else int(ids[t_total + 1])
    return table, rounds, last_changed


def gossip_frontier_packed(
    table, dirty: torch.Tensor, wrap: bool, max_rounds: int, fuse: int = 1,
    tile_n: Optional[int] = None,
) -> Tuple[object, int, int]:
    """Packed frontier convergence loop (ring/chain), in place: per round
    only stripes still changing are touched. ``dirty`` is a bool [t_total]
    seed. Bit-identical final state and classic round count to the
    whole-table loop, also with ``fuse`` > 1 (FUSE rounds per step, exact
    round count rebuilt on the host). Returns (table, rounds,
    last_changed)."""
    p, n = table[0].shape
    if tile_n is None:
        tile_n = frontier_tile_n(n)
    return frontier_loop(
        table, dirty, n // tile_n, max_rounds, fuse,
        lambda m: lambda tbl, ids: frontier_round_packed(tbl, ids, tile_n, wrap, m),
    )


# ------------------------------------------------------- the column pass

# columns a block of the column pass owns: 64 bytes a row a field
COLUMN_GROUP = 16
# the dynamic shared memory a column-pass block may take: an H100 block's
# 232,448 bytes less 4 KB for the kernel's static arrays (3,344 bytes)
COLUMN_PASS_SMEM = 232448 - 4096


def column_pass_smem(p: int, nf: int) -> int:
    """Shared memory of one column-pass block at P rows and nf fields, as
    ``csrc/converge_columns.cu`` reckons it: the group's rows, the holders'
    flags and their 32-row bitmaps."""
    return 4 * COLUMN_GROUP * p * nf + COLUMN_GROUP * p + 4 * COLUMN_GROUP * (-(-p // 32))


def column_pass_fits(p: int, n: int, nf: int) -> bool:
    """Whether the column pass takes a [P, N] table of nf fields: whole
    16-column groups, each within one block's shared memory (P up to 1,087
    packed, 1,564 rank, 2,784 rank1)."""
    return p >= 1 and n % COLUMN_GROUP == 0 and column_pass_smem(p, nf) <= COLUMN_PASS_SMEM


def column_groups(seed, n: int) -> np.ndarray:
    """Ascending int32 ids of the 16-column groups that hold a column of
    ``seed`` (bool [n] on the host; None = every column)."""
    if seed is None:
        return np.arange(n // COLUMN_GROUP, dtype=np.int32)
    # 8 columns a word; strided ORs of a group's words (numpy's reductions
    # along a short last axis take several times as long)
    words = np.ascontiguousarray(seed, dtype=bool).view(np.uint64)
    k = COLUMN_GROUP // 8
    held = words[0::k].copy()
    for i in range(1, k):
        held |= words[i::k]
    return np.flatnonzero(held).astype(np.int32)


def holder_distances(held: torch.Tensor, wrap: bool,
                     ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row's ring (wrap) or chain distance to the nearest row of its
    column that holds (``held``, bool [P, C]); on a chain, the columns of
    ``ends`` (bool [C]) hold one row beyond either end too. Every column
    holds somewhere."""
    if ends is not None:
        rim = ends[None]
        return holder_distances(torch.cat([rim, held, rim]), False)[1:-1]
    p = held.shape[0]
    rows = torch.arange(p, device=held.device)[:, None].expand_as(held)
    far = 4 * p
    prev = torch.where(held, rows, -far).cummax(0).values
    nxt = torch.where(held, rows, far).flip(0).cummin(0).values.flip(0)
    if wrap:
        # past either end the nearest holder is the other end's
        prev = torch.where(prev < 0, prev[-1] - p, prev)
        nxt = torch.where(nxt >= p, nxt[0] + p, nxt)
    return torch.minimum(rows - prev, nxt - rows)


def converge_columns_packed_torch(table, groups: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Plain version of the column pass, in place: every column of the
    16-column ``groups`` becomes its join (the lexmax of its rows; on a
    chain, of its rows and the all-zero entry its ends compare against) in
    every row. Returns the largest over those columns of every row's
    distance to the nearest row that held the join (a chain's ends hold it
    where it is the all-zero entry), int32; -1 with no group."""
    p, _ = table[0].shape
    device = table[0].device
    cols = (groups.to(device, torch.int64)[:, None] * COLUMN_GROUP
            + torch.arange(COLUMN_GROUP, device=device)).flatten()
    depth = -1
    width = max(1, _PLAIN_BLOCK_ELEMS // max(p, 1))
    for c0 in range(0, cols.numel(), width):
        idx = cols[c0:c0 + width]
        sub = [f.index_select(1, idx) for f in table]
        top = torch.ones(sub[0].shape, dtype=torch.bool, device=idx.device)
        for k in table_keys(sub):
            top &= k == torch.where(top, k, torch.iinfo(k.dtype).min).amax(0)
        first = top.to(torch.int8).argmax(0, keepdim=True)
        join = [f.gather(0, first) for f in sub]
        ends = None
        if not wrap:
            ends = ~packed_beats(join, [torch.zeros_like(j) for j in join])[0]
            join = [torch.where(ends, 0, j) for j in join]
        held = torch.stack([f == j for f, j in zip(sub, join)]).all(0)
        depth = max(depth, int(holder_distances(held, wrap, ends).max()))
        for f, j in zip(table, join):
            f.index_copy_(1, idx, j.expand(p, -1).contiguous())
    return torch.tensor(depth, dtype=torch.int32)


def converge_columns_packed(table, seed, wrap: bool,
                            groups: Optional[np.ndarray] = None) -> Tuple[object, torch.Tensor]:
    """Settle a ring's (wrap) or chain's dirty columns in one pass, in place:
    every column of each 16-column group that holds a column of ``seed``
    (bool [n] on the host; None = every column) becomes its join in every
    row; ``groups``, where the caller keeps them, are those groups'
    ascending ids (``column_groups(seed, n)``). The CUDA kernel (``csrc/converge_columns.cu``, one launch) for CUDA
    tensors, the plain version for CPU tensors. Returns (table, depth): the
    largest over those columns of a row's distance to the nearest row that
    held the join (int32, on the table's device), so that the frontier loop
    from the same state would count depth + 1 rounds; -1 with no group."""
    p, n = table[0].shape
    device = table[0].device
    groups = column_groups(seed, n) if groups is None else groups.astype(np.int32)
    if device.type == "cpu":
        return table, converge_columns_packed_torch(table, torch.from_numpy(groups), wrap)
    _fields_checked(table, "converge_columns_packed")
    if not column_pass_fits(p, n, len(table)):
        raise ValueError(f"converge_columns_packed: [{p}, {n}] at nf = {len(table)} takes "
                         f"{column_pass_smem(p, len(table))} bytes of shared memory a block, "
                         f"or n is not a multiple of {COLUMN_GROUP}")
    if any(f.data_ptr() % 16 for f in table):
        raise ValueError("converge_columns_packed: fields must be 16-byte aligned")
    if groups.size == 0:
        return table, torch.tensor(-1, dtype=torch.int32, device=device)
    # the groups, then the depth's cell (zero) after them: one upload
    ids = torch.from_numpy(np.append(groups, np.int32(0))).to(device)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_converge_columns(
            _build.pointers(table), ids.data_ptr(), groups.size, ids[-1:].data_ptr(), p, n,
            int(wrap), len(table), _build.stream_of(device),
        )
    _build.check(err, "converge_columns_packed")
    _build.LAUNCHES["converge_columns"] += 1
    return table, ids[-1]


def gossip_columns_packed(table, seed, wrap: bool,
                          groups: Optional[np.ndarray] = None) -> Tuple[object, int, int]:
    """A ring's or chain's converge to its fixed point as one column pass
    (``converge_columns_packed``), for a loop that no cap can cut short
    (max_rounds above the diameter, which bounds every distance): the table,
    classic round count and residual are those of ``gossip_frontier_packed``
    from the same state, seeded with the stripes that hold ``seed``'s
    columns (``groups`` as ``converge_columns_packed`` takes them). Returns
    (table, rounds, 0). The span ``loop`` counts its
    ``steps`` (launches), ``stripe_steps`` (0), ``waits`` (the depth's read
    back, ``loop.wait``) and the dirty ``columns`` it settled."""
    n = table[0].shape[1]
    with observe.span("loop") as sp:
        table, depth = converge_columns_packed(table, seed, wrap, groups)
        with observe.span("loop.wait"):
            rounds = int(depth) + 1
        sp.set(steps=int(table[0].is_cuda and rounds > 0), stripe_steps=0, waits=1)
        if observe.recording():  # a pass over the seed: only for a trace
            sp.set(columns=n if seed is None else int(np.count_nonzero(seed)))
    return table, rounds, 0


# -------------------------------------------------------- the graph pass

# columns a block of the graph pass owns: one 32-byte sector a row a field
GRAPH_GROUP = 8
# the most rows a block of the graph pass takes (six a thread of 512)
GRAPH_MAX_ROWS = 3072
# a group of at least this many slots takes a warp a row, not a thread
GRAPH_WARP_RUN = 8


def graph_pass_smem(p: int, nf: int) -> int:
    """Shared memory of one graph-pass block at P rows and nf fields, as
    ``csrc/converge_graph.cu`` reckons it: the group's 8 columns, each of
    P rounded up to 32, plus 4, words a field, and a byte a row."""
    return 4 * GRAPH_GROUP * nf * (-(-p // 32) * 32 + 4) + p


def graph_pass_fits(p: int, nf: int) -> bool:
    """Whether the graph pass takes P rows of nf fields: within a block's
    registers (3,072 rows) and shared memory (P up to 2,336 packed). Beyond
    it the plain round loop runs."""
    return 1 <= p <= GRAPH_MAX_ROWS and graph_pass_smem(p, nf) <= COLUMN_PASS_SMEM


class GraphPlan:
    """A neighbour matrix [P, D] (-1 = none) as the graph pass reads it.
    ``order`` holds the row at each position: the rows sorted by their
    extent (last slot that has a neighbour, + 1), longest first and stable,
    so that the rows active in slot k are a prefix of the positions;
    ``row_off`` and ``nbr`` are a CSR of each position's neighbours in slot
    order, as positions (-1: a hole in the matrix); ``sched`` groups the
    slots [k0, k1) with the positions active at k0 and whether a warp takes
    each row. ``neighbors`` is the matrix as given, which the plain version
    reads."""

    def __init__(self, neighbors) -> None:
        nb = np.asarray(neighbors, dtype=np.int64)
        p, d = nb.shape
        if p > np.iinfo(np.int16).max:
            raise ValueError(f"GraphPlan: {p} rows do not fit int16 positions")
        valid = nb >= 0
        extent = np.where(valid.any(1), d - np.argmax(valid[:, ::-1], axis=1), 0)
        order = np.argsort(-extent, kind="stable")
        pos = np.empty(p, dtype=np.int64)
        pos[order] = np.arange(p)
        ext = extent[order]
        sub = nb[order]
        as_pos = np.where(sub >= 0, pos[np.clip(sub, 0, None)], -1)
        self.neighbors = nb.astype(np.int32)
        self.order = order.astype(np.int32)
        self.row_off = np.concatenate([[0], np.cumsum(ext)]).astype(np.int32)
        self.nbr = as_pos[np.arange(d)[None, :] < ext[:, None]].astype(np.int16)
        self.edges = int(valid.sum())
        self.max_degree = int(valid.sum(1).max(initial=0))
        active = (ext[:, None] > np.arange(d)[None, :]).sum(0)
        read_min = np.where(as_pos >= 0, as_pos, p).min(0, initial=p)
        sched, k, slots = [], 0, int(ext.max(initial=0))
        while k < slots:
            a, k1 = int(active[k]), k + 1
            if read_min[k] >= a:  # nothing written is read: the next slots may join
                while k1 < slots and read_min[k1] >= a:
                    k1 += 1
            sched.append((k, k1, a, int(k1 - k >= GRAPH_WARP_RUN)))
            k = k1
        self.sched = np.asarray(sched, dtype=np.int32).reshape(-1, 4)
        self._on: dict = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plan on ``device``, uploaded once: int32 (the schedule, each
        position's row, the CSR's offsets) and the int16 neighbours."""
        device = torch.device(device)
        if device not in self._on:
            i32 = np.concatenate([self.sched.ravel(), self.order, self.row_off])
            self._on[device] = (torch.from_numpy(i32.astype(np.int32)).to(device),
                                torch.from_numpy(self.nbr).to(device))
        return self._on[device]


def graph_work(seed, n: int, groups: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The 8-column groups that hold a column of ``seed`` (bool [n] on the
    host; None = every column), ascending int32, and each one's dirty
    columns as a bit mask (int32); ``groups``, where the caller keeps them,
    are the 16-column groups (``column_groups``) that hold them."""
    if seed is None:
        ids = np.arange(n // GRAPH_GROUP, dtype=np.int32)
        return ids, np.full(ids.size, (1 << GRAPH_GROUP) - 1, dtype=np.int32)
    cols = np.ascontiguousarray(seed, dtype=bool)
    words = cols.view(np.uint64)  # 8 columns a word
    if groups is None:
        ids = np.flatnonzero(words)
    else:
        k = COLUMN_GROUP // GRAPH_GROUP
        cand = (np.asarray(groups, dtype=np.int64)[:, None] * k + np.arange(k)).ravel()
        ids = cand[words[cand] != 0]
    masks = np.packbits(cols.reshape(-1, GRAPH_GROUP)[ids], axis=1, bitorder="little")[:, 0]
    return ids.astype(np.int32), masks.astype(np.int32)


def converge_graph_packed_torch(table, plan: GraphPlan, groups: torch.Tensor,
                                masks: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of the graph pass, in place: the dirty columns of the
    8-column ``groups`` (``masks``: each one's columns) run the reference's
    rounds (``gossip_round_generic_packed``) until a round changes nothing
    or ``cap`` rounds. Returns int32 [1 + min(cap, P + 1)]: the largest last
    round that changed a column (0 if none did), then each round's count
    (wrapping like int32)."""
    p = table[0].shape[0]
    device = table[0].device
    cap = max(1, cap)
    counts = np.zeros(min(cap, p + 1), dtype=np.int64)
    bits = torch.arange(GRAPH_GROUP, device=device)
    pick = (masks.to(device, torch.int64)[:, None] >> bits) & 1
    cols = (groups.to(device, torch.int64)[:, None] * GRAPH_GROUP + bits)[pick.bool()]
    depth = 0
    width = max(1, _PLAIN_BLOCK_ELEMS // max(p, 1))
    for c0 in range(0, cols.numel(), width):
        idx = cols[c0:c0 + width]
        sub = type(table)(*(f.index_select(1, idx) for f in table))
        for r in range(1, cap + 1):
            sub, changed = gossip_round_generic_packed(sub, plan.neighbors)
            total = int(changed)
            if total == 0:
                break
            depth = max(depth, r)
            counts[r - 1] += total
        for f, s in zip(table, sub):
            f.index_copy_(1, idx, s)
    return torch.tensor([depth, *(_wrap_int32(int(c)) for c in counts)], dtype=torch.int32)


def converge_graph_packed(table, plan: GraphPlan, work: Tuple[np.ndarray, np.ndarray],
                          cap: int) -> Tuple[object, torch.Tensor]:
    """Run the reference's rounds on the dirty columns of ``work``
    (``graph_work``: 8-column groups and their masks) over ``plan``'s
    neighbour matrix, in place, each column until a round changes nothing
    there or ``cap`` rounds (>= 1): the CUDA kernel
    (``csrc/converge_graph.cu``, one launch) for CUDA tensors, the plain
    version for CPU tensors. A column the rounds would not change must be
    at a fixed point (settled since it was last written), and no entry may
    lie below the all-zero entry, as none a sim stores does: a missing
    neighbour's merge, of that entry, is skipped. Returns (table,
    int32 [1 + min(cap, P + 1)] on the table's device): the largest last
    round that changed a column (0 if none did), then each round's count
    summed over the columns (wrapping like int32), so that the whole-table
    loop from the same state runs min(cap, that round + 1) rounds with
    those counts."""
    p, n = table[0].shape
    device = table[0].device
    groups, masks = work
    if n % GRAPH_GROUP:
        raise ValueError(f"converge_graph_packed: n = {n} is not a multiple of {GRAPH_GROUP}")
    if plan.neighbors.shape[0] != p:
        raise ValueError(f"converge_graph_packed: a plan of {plan.neighbors.shape[0]} rows "
                         f"for a table of {p}")
    cap = max(1, min(cap, p + 1))  # a column settles within P rounds
    if device.type == "cpu":
        return table, converge_graph_packed_torch(
            table, plan, torch.from_numpy(groups), torch.from_numpy(masks), cap)
    _fields_checked(table, "converge_graph_packed")
    if not graph_pass_fits(p, len(table)):
        raise ValueError(f"converge_graph_packed: {p} rows at nf = {len(table)} take "
                         f"{graph_pass_smem(p, len(table))} bytes of shared memory a block")
    if any(f.data_ptr() % 16 for f in table):
        raise ValueError("converge_graph_packed: fields must be 16-byte aligned")
    # the groups, their masks, then the output cells (zero): one upload
    cells = torch.from_numpy(np.concatenate(
        [groups, masks, np.zeros(1 + cap, dtype=np.int32)])).to(device)
    out = cells[2 * groups.size:]
    if groups.size == 0:
        return table, out
    i32, nbr = plan.on(device)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_converge_graph(
            _build.pointers(table), cells.data_ptr(), groups.size, i32.data_ptr(),
            nbr.data_ptr(), plan.sched.shape[0], out.data_ptr(), cap, p, n, cap, len(table),
            _build.stream_of(device),
        )
    _build.check(err, "converge_graph_packed")
    _build.LAUNCHES["converge_graph"] += 1
    return table, out


def gossip_graph_packed(table, plan: GraphPlan, seed, max_rounds: int,
                        groups: Optional[np.ndarray] = None
                        ) -> Tuple[object, int, int, List[int]]:
    """The whole-table round loop of any neighbour matrix
    (``gossip_until_converged_packed`` over ``gossip_round_generic_packed``)
    as one graph pass over the columns of ``seed`` (bool [n] on the host;
    None = every column; ``groups`` as ``graph_work`` takes them), every
    other column at a fixed point: the same table, rounds, last count and
    every round's count. Returns (table, rounds, last round's count, the
    counts of rounds 1 .. rounds); max_rounds = 0 runs nothing (0 rounds,
    count 1). The span ``loop`` counts its ``steps`` (rounds), ``waits``
    (the one read of the counts, ``loop.wait``), the CSR's ``edges`` and
    ``max_degree``, and, in a trace, the dirty ``columns`` and the 8-column
    ``sectors`` it read."""
    if max_rounds <= 0:
        return table, 0, 1, []
    n = table[0].shape[1]
    with observe.span("loop") as sp:
        work = graph_work(seed, n, groups)
        table, out = converge_graph_packed(table, plan, work, max_rounds)
        with observe.span("loop.wait"):
            depth, *counts = out.tolist()
        rounds = min(max_rounds, depth + 1)
        sp.set(steps=rounds, waits=1, edges=plan.edges, max_degree=plan.max_degree)
        if observe.recording():  # a pass over the seed: only for a trace
            sp.set(columns=n if seed is None else int(np.count_nonzero(seed)),
                   sectors=int(work[0].size))
    counts = counts[:rounds]
    return table, rounds, counts[-1], counts


# ----------------------------------------------- per-shard steps (device mesh)

# the window depths of the spmd window frontier, deepest first
WINDOW_DEPTHS = (63, 31, 15)
# the reference's TPU tiling minima (8 sublanes, 128 lanes): they decide
# WHERE a packed sim takes the frontier on a mesh, never the port's tiling
_SUBLANES, _LANES = 8, 128
# a distance no window radius reaches: the line shift's fill, which never
# survives a live compare
_DIST_FILL = 1 << 24


def frontier_available_sharded(p: int, n: int, shards: int) -> bool:
    """Whether the reference runs its packed frontier on a mesh of
    ``shards`` at [p, n] (``frontier_tile_n_sharded(p, n, shards) > 0``,
    ``ops/packed.py:2451``): P divides evenly, each shard holds at least 8
    rows, a multiple of 8, and n % 128 == 0 (its stripe search then always
    finds 128). The port's stripe width is its own, ``frontier_tile_n``."""
    if shards <= 0 or p % shards:
        return False
    b = p // shards
    return b % _SUBLANES == 0 and b >= _SUBLANES and n % _LANES == 0


def window_frontier_depth(b: int, n: int) -> int:
    """The m of the reference's ``window_frontier_params(nf, b, n)``
    (``ops/packed.py:2963``) for shards of b rows: the deepest of
    WINDOW_DEPTHS that is <= b (a slab comes from one neighbour), 0 where
    none is or the shape is not the sharded frontier's. The reference's
    VMEM budget only picks its tile: once b >= 8, b % 8 == 0 and
    n % 128 == 0, a 128-wide tile divides n and is accepted at every
    depth, so the budget never decides m. The port's tile is
    ``frontier_tile_n(n)``."""
    if b % _SUBLANES or b < _SUBLANES or n % _LANES:
        return 0
    return next((m for m in WINDOW_DEPTHS if m <= b), 0)


def frontier_shard_round_packed(fields, tops, bottoms, ids: torch.Tensor, tile_n: int,
                                m: int = 1, out: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """One per-shard frontier step of ``m`` rounds on a packed-family shard
    (see ``ring_kernel.frontier_shard_round_torch``, whose plain version it
    runs with ``packed_beats`` for CPU tensors): the CUDA kernel
    (``csrc/frontier_shard.cu``) for CUDA tensors. ``tops`` and ``bottoms``
    hold the neighbour shards' s >= m boundary rows; the kernel only reads
    them at m = 1 and m = 8 (one pipelined pass), and uses them as scratch
    at any other m, so no caller may depend on their contents after the
    call. m = 1 is the port of the reference's
    ``_frontier_halo_kernel_counts`` (which reads one row of its 8-row
    pads), m = 8 of ``_frontier_shard_multiround_kernel_packed``. Returns
    the int32 [m, t_total] per-round, per-stripe counts of the shard's
    rows, in ``out`` when given (zeroed, on the shard's device: the
    shard's row of the mesh's fold buffer)."""
    nf = len(fields)
    if nf not in (1, 2, 3):
        raise ValueError(f"frontier_shard_round_packed takes 1, 2 or 3 fields, got {nf}")
    check_shard_step(fields, tops, bottoms, tile_n, m, m)
    if fields[0].device.type == "cpu":
        return plain_into(
            frontier_shard_round_torch(fields, tops, bottoms, ids, tile_n, packed_beats, m), out)
    counts = shard_step_out(fields, out, m, tile_n, "frontier_shard_round_packed")
    launch_shard_step("frontier_shard_packed", fields, tops, bottoms, ids, tile_n, (counts,),
                      m, nf)
    _build.LAUNCHES["frontier_shard packed" if m == 1 else "frontier_shard packed fused"] += 1
    return counts


def _shift_line(f: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """Rows of ``f`` moved down by ``s`` (up for s < 0), the vacated rows
    ``fill``: line semantics, no wrap (the extended column's slabs already
    hold the ring's neighbourhood)."""
    out = torch.full_like(f, fill)
    rows = f.shape[0]
    if abs(s) < rows:
        if s >= 0:
            out[s:] = f[:rows - s]
        else:
            out[:rows + s] = f[-s:]
    return out


def _keys_eq(b_keys, a_keys) -> torch.Tensor:
    """Equality of two whole key chains (the same lattice value)."""
    eq = b_keys[0] == a_keys[0]
    for kb, ka in zip(b_keys[1:], a_keys[1:]):
        eq = eq & (kb == ka)
    return eq


def _window_dist_chain(vals: List[torch.Tensor], dist: torch.Tensor, m: int):
    """Plain twin of the reference's ``_window_dist_chain``: join ``vals``
    to window radius ``m`` on a line in O(log m) doubling steps, keeping in
    ``dist`` each entry's least distance to a source of its current value.
    A step joins copies shifted by +-s, s <= r + 1, carrying the candidate
    distance d + s: a strict win takes it, an equal key the smaller one.
    Returns (vals, dist)."""
    r = 0
    while r < m:
        s = min(m - r, r + 1)
        for sign in (1, -1):
            shifted = [_shift_line(f, sign * s, 0) for f in vals]
            cand = _shift_line(dist, sign * s, _DIST_FILL - s) + s
            kb, ka = table_keys(shifted), table_keys(vals)
            gt, eq = lex_gt(kb, ka), _keys_eq(kb, ka)
            vals = [torch.where(gt, fb, fa) for fa, fb in zip(vals, shifted)]
            dist = torch.where(gt, cand, torch.where(eq, torch.minimum(dist, cand), dist))
        r += s
    return vals, dist


def frontier_shard_window_torch(fields, tops, bottoms, ids: torch.Tensor, tile_n: int,
                                m: int) -> torch.Tensor:
    """Plain version of one per-shard window step, the port of the
    reference's ``_frontier_shard_window_kernel_packed``: on each stripe of
    ``ids[:ids[t_total]]`` the extended column [m rows ``tops`` | the
    shard's b rows | m rows ``bottoms``] joins to radius m by the distance
    chain, and the shard's rows take their new values, in place (m rounds,
    exact: the slabs are m deep). Returns the window stats, int32
    [2, t_total]: row 0 the shard's entries the step changed, row 1 the
    largest distance of a changed entry to its value's source (its last
    changed round); zero for stripes not in ids."""
    b, n = fields[0].shape
    t_total = n // tile_n
    device = fields[0].device
    stats = torch.zeros((2, t_total), dtype=torch.int32, device=device)
    count = int(ids[t_total])
    if count == 0:
        return stats
    stripes = ids[:count].to(device=device, dtype=torch.int64)
    lanes = torch.arange(tile_n, device=device)
    per_block = max(1, _PLAIN_BLOCK_ELEMS // max((b + 2 * m) * tile_n, 1))
    for s0 in range(0, count, per_block):
        s1 = min(count, s0 + per_block)
        cols = (stripes[s0:s1, None] * tile_n + lanes).reshape(-1)
        orig = [f.index_select(1, cols) for f in fields]
        ext = [torch.cat([t.index_select(1, cols), o, bo.index_select(1, cols)])
               for o, t, bo in zip(orig, tops, bottoms)]
        ext, dist = _window_dist_chain(ext, torch.zeros_like(ext[0]), m)
        new = [e[m:m + b] for e in ext]
        changed = packed_beats(new, orig)
        per_stripe = (b, s1 - s0, tile_n)
        stats[0, stripes[s0:s1]] = changed.reshape(per_stripe).sum((0, 2)).to(torch.int32)
        last = torch.where(changed, dist[m:m + b], 0).reshape(per_stripe).amax((0, 2))
        stats[1, stripes[s0:s1]] = last.to(torch.int32)
        for f, v in zip(fields, new):
            f.index_copy_(1, cols, v)
    return stats


def frontier_shard_window(fields, tops, bottoms, ids: torch.Tensor, tile_n: int,
                          m: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One per-shard window step of ``m`` rounds on a packed-family shard
    (see ``frontier_shard_window_torch``): the CUDA kernel
    (``csrc/frontier_shard_window.cu``: the distance chain on a tile of the
    extended column in shared memory, read and written once) for CUDA
    tensors, the plain version for CPU tensors. ``tops`` and ``bottoms``
    are the neighbour shards' [m, N] slabs, taken before any shard's step;
    the kernel only reads them. Returns the int32 [2, t_total] window
    stats, in ``out`` when given (zeroed, on the shard's device: the kernel
    adds into it); the caller folds the shards' stats, row 0 summed and
    row 1 maxed (``compact_counts_window``)."""
    nf = len(fields)
    if nf not in (1, 2, 3):
        raise ValueError(f"frontier_shard_window takes 1, 2 or 3 fields, got {nf}")
    check_shard_step(fields, tops, bottoms, tile_n, m, m)
    if tops[0].shape[0] != m:
        raise ValueError(f"a window of {m} rounds takes {m}-row slabs, got {tops[0].shape[0]}")
    if fields[0].device.type == "cpu":
        return plain_into(frontier_shard_window_torch(fields, tops, bottoms, ids, tile_n, m), out)
    stats = shard_step_out(fields, out, 2, tile_n, "frontier_shard_window")
    launch_shard_step("frontier_shard_window", fields, tops, bottoms, ids, tile_n, (stats,), nf)
    _build.LAUNCHES["frontier_shard_window"] += 1
    return stats


def compact_counts_window_torch(stats: torch.Tensor, m: int,
                                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the window fold: the S shards' int32 [S, 2, t_total]
    window stats, agreed as the reference's shard_map does (row 0 summed
    over the shards, wrapping like int32; row 1 maxed) -> the fused ids
    array [t_total + 3] (in ``out`` when given): the stripes whose last
    changed round is m, ascending (the others reached their fixed point
    inside the window); their count; the total of row 0 (wrapping like
    int32); the max of row 1 (at least 0). Cells past the count are zero.
    Zeroes ``stats``, as the kernel does."""
    t_total = stats.shape[2]
    total = stats[:, 0].to(torch.int64).sum(0)
    last = stats[:, 1].to(torch.int64).amax(0)
    stats.zero_()
    keep = torch.nonzero(last == m).flatten()
    ids = _ids_out(out, t_total + 3, stats.device, "compact_counts_window")
    ids.zero_()
    ids[: keep.numel()] = keep.to(torch.int32)
    ids[t_total] = keep.numel()
    ids[t_total + 1] = _wrap_int32(int(total.sum()))
    ids[t_total + 2] = max(0, int(last.max())) if t_total else 0
    return ids


def compact_counts_window(stats: torch.Tensor, m: int,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The window fold (see ``compact_counts_window_torch``) of the shards'
    [S, 2, t_total] stats for a window of m >= 2 rounds, one launch: the
    CUDA kernel (``csrc/compact_counts.cu``, one block, which zeroes the
    stats as it reads them) for a CUDA tensor, the plain version for a CPU
    tensor. The port of the reference's psum and pmax over the shards and
    its ``compact_counts_window_packed``. ``out`` as in ``compact_counts``.
    Cells of the result past its count are left unwritten by the kernel."""
    if (stats.dim() != 3 or stats.shape[0] < 1 or stats.shape[1] != 2
            or stats.dtype != torch.int32):
        raise ValueError("compact_counts_window takes int32 [S >= 1, 2, t_total] stats")
    if m < 2:
        raise ValueError(f"a window folds m >= 2 rounds, got {m}")
    if stats.device.type == "cpu":
        return compact_counts_window_torch(stats, m, out)
    device = stats.device
    _build.require_cuda(device, "compact_counts_window")
    shards, _, t_total = stats.shape
    _build.check_fields((stats,), (shards, 2, t_total), device, "compact_counts_window")
    ids = _ids_out(out, t_total + 3, device, "compact_counts_window")
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_compact_counts_window(
            stats.data_ptr(), ids.data_ptr(), shards, m, t_total, _build.stream_of(device)
        )
    _build.check(err, "compact_counts_window")
    _build.LAUNCHES["compact_counts window"] += 1
    return ids
