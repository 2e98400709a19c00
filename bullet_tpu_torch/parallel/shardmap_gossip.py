"""Explicit SPMD gossip on a sharded table.

The port of ``bullet_tpu.parallel.shardmap_gossip``: per-shard local merges
plus hand-placed exchanges between the shards of a ``ShardedTable``, for
the dense layout (full or lean) and the packed family (packed, rank,
rank1). The reference ran one ``shard_map`` program under a single
controller; here one process drives every shard. Its ``ppermute``
becomes a ``copy_`` of the boundary rows into the neighbour shard's
device, its ``psum`` of the frontier's counts (``pmax``) a fold of the
shards' rows of one buffer on the mesh's first device inside the
compaction's launch, its ``all_gather`` a copy of the rows a shard needs.

* ring/chain — one exchanged boundary row each way, chain ends zeroed;
  the per-shard frontier kernel at m = 1 over every stripe, in place,
  where the frontier stripes the slots.
* full mesh — recursive doubling: log2(P) global rolls, each a whole-shard
  hop plus a remainder splice (``_global_roll``); bit-identical to
  ``gossip_round_mesh`` including change counts. Lean joins four fields.
* star — the hub is the lattice max of all rows (per-shard reduce, then
  across shards); the spokes merge the hub's pre-round row. The count is
  the strict-improvement count against the pre-round hub (zero iff the
  unsharded count is zero).
* generic — per neighbour column, each shard takes its neighbours' CURRENT
  rows from their shards and merges them, bit-identical to
  ``gossip_round_generic`` including counts.
* the frontier — per-shard frontier steps (``frontier_shard.cu``) between
  boundary exchanges, each writing its counts into its row of one buffer,
  which one launch a step folds over the shards and compacts
  (``compact_counts.cu``) into the next step's ids array; the packed
  family also as m-round windows (``frontier_shard_window.cu``, its stats
  folded by ``compact_counts.cu``).
* the packed ``fast_forward`` window — m rounds per exchange of m-row
  slabs, a window join per shard (``window_packed.cu``'s extended form;
  XLA code in the reference).

Every merge runs the kernels on CUDA tensors and their plain versions on
CPU tensors. A round returns a new ``ShardedTable`` whose shards may be the
old ones updated in place.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.merge import TableState, lean_fields, merge_lean, merge_tables
from ..ops.packed import (
    compact_counts,
    compact_counts_window,
    frontier_loop,
    frontier_shard_round_packed,
    frontier_shard_window,
    merge_packed_torch,
    reconcile_packed,
    ring_window_shard_packed,
)
from ..ops.ring_kernel import frontier_shard_round, frontier_tile_n
from .gossip import lean_round_applies
from .mesh import Mesh, ShardedTable

# rounds one boundary exchange buys the fused frontier (the reference's
# HALO_FUSE: the 8-row boundary snapshots)
HALO_FUSE = 8

# merge(shard, fields) -> (merged shard, count): a shard's merge with rows
# of its merged fields (every field, or a lean shard's four value keys)
Merge = Callable[[object, Sequence[torch.Tensor]], Tuple[object, torch.Tensor]]


def _parts(table: ShardedTable, lean: bool) -> List[Tuple[torch.Tensor, ...]]:
    """Each shard's merged fields: the four value keys (lean) or all."""
    return [lean_fields(s) if lean else tuple(s) for s in table.shards]


def _copy_rows(src: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """Copies of [r, N] row blocks on ``device`` (the ppermute)."""
    return [torch.empty(f.shape, dtype=f.dtype, device=device).copy_(f) for f in src]


def boundary_rows(parts, s: int, wrap: bool, mesh: Mesh):
    """The s rows above (tops) and below (bottoms) every shard, copied onto
    the shard's device: shard i's tops are the last s rows of shard i - 1,
    its bottoms the first s rows of shard i + 1, wrapping around the mesh;
    on a chain the first shard's tops and the last shard's bottoms are
    zeros. Every copy is taken before the caller writes any shard."""
    k = len(parts)
    tops, bottoms = [], []
    for i, dev in enumerate(mesh):
        if wrap or i > 0:
            tops.append(_copy_rows([f[-s:] for f in parts[(i - 1) % k]], dev))
        else:
            tops.append([torch.zeros((s, f.shape[1]), dtype=f.dtype, device=dev) for f in parts[i]])
        if wrap or i < k - 1:
            bottoms.append(_copy_rows([f[:s] for f in parts[(i + 1) % k]], dev))
        else:
            bottoms.append([torch.zeros((s, f.shape[1]), dtype=f.dtype, device=dev) for f in parts[i]])
    return tops, bottoms


def _zero_count(mesh: Mesh) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=mesh[0])


def _dense_merge(mode: str, lean: bool) -> Merge:
    """The dense layout's merge: the lean merge in place into the shard's
    value keys, or the full merge into a new table."""
    if lean:
        return lambda a, b: (a, merge_lean(lean_fields(a), b))
    return lambda a, b: merge_tables(a, TableState(*b), mode)


def _packed_merge(a, b: Sequence[torch.Tensor]):
    """The packed family's merge into a new table of ``a``'s layout."""
    return merge_packed_torch(a, type(a)(*b))


def _ring_exchange(table: ShardedTable, parts, wrap: bool, shard_step: Callable,
                   merge: Merge) -> Tuple[ShardedTable, torch.Tensor]:
    """One ring (wrap) or chain round of the shards' merged fields
    ``parts``: each shard merges its rows shifted by one with the exchanged
    boundary row filling the gap, up then down, from the pre-round rows.
    Where the frontier stripes the slots this is ``shard_step(fields, top,
    bottom, ids, tile_n)``, the per-shard frontier step at m = 1 over every
    stripe, in place; otherwise each shard merges shifted copies. Returns
    (table, changed) with the count summed on mesh[0]."""
    tops, bottoms = boundary_rows(parts, 1, wrap, table.mesh)
    total = _zero_count(table.mesh)
    tile_n = frontier_tile_n(table.shape[1])
    if tile_n:
        t_total = table.shape[1] // tile_n
        for f, top, bottom, dev in zip(parts, tops, bottoms, table.mesh):
            ids = torch.arange(t_total + 2, dtype=torch.int32, device=dev)
            ids[t_total] = t_total
            counts = shard_step(f, top, bottom, ids, tile_n)
            total = total + counts.sum(dtype=torch.int32).to(table.mesh[0])
        return table, total
    shards = []
    for shard, f, top, bottom in zip(table.shards, parts, tops, bottoms):
        up = [torch.cat([t, x[:-1]]) for x, t in zip(f, top)]
        down = [torch.cat([x[1:], bo]) for x, bo in zip(f, bottom)]
        shard, c1 = merge(shard, up)
        shard, c2 = merge(shard, down)
        shards.append(shard)
        total = total + (c1 + c2).to(table.mesh[0])
    return ShardedTable(shards, table.mesh), total


def ring_round_shardmap(
    table: ShardedTable, mode: str = "reference", wrap: bool = True, lean: bool = False
) -> Tuple[ShardedTable, torch.Tensor]:
    """One ring (wrap) or chain round of a dense sharded table (see
    ``_ring_exchange``); ``lean`` merges the four value keys. Returns
    (table, changed)."""
    return _ring_exchange(
        table, _parts(table, lean), wrap,
        lambda f, top, bottom, ids, tile_n: frontier_shard_round(
            f, top, bottom, ids, tile_n, mode, 1),
        _dense_merge(mode, lean),
    )


def ring_round_shardmap_packed(table: ShardedTable, wrap: bool = True):
    """One ring (wrap) or chain round of a packed-family sharded table (see
    ``_ring_exchange``): the per-shard step is ``frontier_shard_round_packed``
    at m = 1 (the port of ``_frontier_halo_kernel_counts``). Bit-identical
    to the unsharded round, count included. Returns (table, changed)."""
    return _ring_exchange(
        table, _parts(table, False), wrap,
        lambda f, top, bottom, ids, tile_n: frontier_shard_round_packed(
            f, top, bottom, ids, tile_n, 1),
        _packed_merge,
    )


def _global_roll(parts, s: int, mesh: Mesh) -> List[List[torch.Tensor]]:
    """``torch.roll(·, s, 0)`` of the whole table, per shard on its own
    device: rows hop ``s // b`` whole shards, and the ``s % b`` remainder
    splices the boundary between two hopped blocks."""
    k = len(parts)
    b = parts[0][0].shape[0]
    d, r = divmod(s % (k * b), b)
    out = []
    for j, dev in enumerate(mesh):
        from_d = parts[(j - d) % k]
        if r == 0:
            out.append(_copy_rows(from_d, dev))
            continue
        from_d1 = parts[(j - d - 1) % k]
        out.append([
            torch.cat([f1[b - r:].to(dev), f0[:b - r].to(dev)])
            for f0, f1 in zip(from_d, from_d1)
        ])
    return out


def _mesh_doubling(table: ShardedTable, lean: bool, merge: Merge):
    """Recursive doubling over global rolls of the shards' merged fields;
    each step takes every shard's rolled rows before it merges any."""
    p = table.shape[0]
    total = _zero_count(table.mesh)
    for k in range(max(1, (p - 1).bit_length())):
        rolled = _global_roll(_parts(table, lean), 1 << k, table.mesh)
        shards = []
        for shard, rows in zip(table.shards, rolled):
            shard, c = merge(shard, rows)
            shards.append(shard)
            total = total + c.to(table.mesh[0])
        table = ShardedTable(shards, table.mesh)
    return table, total


def mesh_round_shardmap(
    table: ShardedTable, mode: str = "reference", lean: bool = False
) -> Tuple[ShardedTable, torch.Tensor]:
    """One full-mesh round of a dense sharded table by recursive doubling:
    bit-identical to ``gossip_round_mesh`` (``lean`` as its lean join, the
    reconcile of a lean sim)."""
    return _mesh_doubling(table, lean, _dense_merge(mode, lean))


def mesh_round_shardmap_packed(table: ShardedTable):
    """One full-mesh round of a packed-family sharded table by recursive
    doubling: bit-identical to ``gossip_round_mesh_packed``, count
    included."""
    return _mesh_doubling(table, False, _packed_merge)


def _row_max(rows, merge: Merge):
    """The lexmax of [r, N] rows (a table) as one row, keeping the earliest
    row on equal keys (the reference's sequential row-by-row merge; in the
    packed family equal keys are equal entries): pairwise halving, the
    lower rows always the first operand."""
    ctor = type(rows)
    while rows[0].shape[0] > 1:
        r = rows[0].shape[0]
        half = r // 2
        merged, _ = merge(ctor(*(f[0:2 * half:2].contiguous() for f in rows)),
                          [f[1:2 * half:2].contiguous() for f in rows])
        if r % 2:
            merged = ctor(*(torch.cat([m, f[r - 1:]]) for m, f in zip(merged, rows)))
        rows = merged
    return rows


def _star_exchange(table: ShardedTable, hub: int, merge: Merge):
    """One star round: every row merges the hub's pre-round row, and the
    hub becomes the lattice max of all rows (each shard's max, then across
    shards on the hub's device). Values are the unsharded generic round's;
    the count is the strict-improvement count against the pre-round hub
    (zero iff the unsharded count is zero)."""
    b = table.rows
    ctor = type(table.shards[0])
    hub_dev, hub_row = divmod(hub, b)
    hub_device = table.mesh[hub_dev]
    hub_old = ctor(*(f[hub_row:hub_row + 1].clone() for f in table.shards[hub_dev]))
    maxima = [ctor(*(f.to(hub_device) for f in _row_max(s, merge))) for s in table.shards]
    gmax = _row_max(ctor(*(torch.cat(fs) for fs in zip(*maxima))), merge)
    new_hub, c_hub = merge(hub_old, gmax)
    total = c_hub.to(table.mesh[0])
    shards = []
    for shard, dev in zip(table.shards, table.mesh):
        bcast = [f.to(dev).expand(b, f.shape[1]).contiguous() for f in hub_old]
        merged, c = merge(shard, bcast)
        shards.append(merged)
        total = total + c.to(table.mesh[0])
    for f, h in zip(shards[hub_dev], new_hub):
        f[hub_row] = h[0]
    return ShardedTable(shards, table.mesh), total


def star_round_shardmap(
    table: ShardedTable, mode: str = "reference", hub: int = 0
) -> Tuple[ShardedTable, torch.Tensor]:
    """One star round of a dense sharded table (see ``_star_exchange``)."""
    return _star_exchange(table, hub, _dense_merge(mode, False))


def star_round_shardmap_packed(table: ShardedTable, hub: int = 0):
    """One star round of a packed-family sharded table (see
    ``_star_exchange``)."""
    return _star_exchange(table, hub, _packed_merge)


def _generic_exchange(table: ShardedTable, neighbors: np.ndarray, merge: Merge):
    """One round over an arbitrary adjacency ([P, max_deg], -1 padding):
    per neighbour column every shard takes its peers' neighbours' current
    rows from their shards (padding masked to all-zero rows, which never
    win), then merges them; bit-identical to the unsharded generic round
    including counts."""
    b = table.rows
    total = _zero_count(table.mesh)
    for k in range(neighbors.shape[1]):
        gathered = []
        for i, dev in enumerate(table.mesh):
            col = neighbors[i * b:(i + 1) * b, k]
            valid = torch.from_numpy(col >= 0).to(dev)[:, None]
            rows = table.take_rows(np.where(col >= 0, col, 0), dev)
            gathered.append([torch.where(valid, f, torch.zeros_like(f)) for f in rows])
        shards = []
        for shard, rows in zip(table.shards, gathered):
            shard, c = merge(shard, rows)
            shards.append(shard)
            total = total + c.to(table.mesh[0])
        table = ShardedTable(shards, table.mesh)
    return table, total


def generic_round_shardmap(
    table: ShardedTable, neighbors: np.ndarray, mode: str = "reference"
) -> Tuple[ShardedTable, torch.Tensor]:
    """One generic round of a dense sharded table (``gossip_round_generic``'s
    bits and count; see ``_generic_exchange``)."""
    return _generic_exchange(table, neighbors, _dense_merge(mode, False))


def generic_round_shardmap_packed(table: ShardedTable, neighbors: np.ndarray):
    """One generic round of a packed-family sharded table
    (``gossip_round_generic_packed``'s bits and count)."""
    return _generic_exchange(table, np.asarray(neighbors), _packed_merge)


def shardmap_round(
    table: ShardedTable, topology, mode: str = "reference"
) -> Tuple[ShardedTable, torch.Tensor]:
    """One explicit-SPMD round for any topology, full metadata (the
    reference's ``shardmap_round``): ring/chain exchange, recursive
    doubling for a mesh, the hub reduce for a star, gathers otherwise."""
    if topology.kind in ("ring", "chain"):
        return ring_round_shardmap(table, mode, wrap=topology.kind == "ring")
    if topology.kind == "mesh":
        return mesh_round_shardmap(table, mode)
    if topology.name == "star":
        return star_round_shardmap(table, mode, hub=int(np.argmax(topology.degree())))
    return generic_round_shardmap(table, topology.neighbors, mode)


def shardmap_round_packed(table: ShardedTable, topology) -> Tuple[ShardedTable, torch.Tensor]:
    """The packed twin of ``shardmap_round`` (the reference's
    ``shardmap_round_packed``)."""
    if topology.kind in ("ring", "chain"):
        return ring_round_shardmap_packed(table, wrap=topology.kind == "ring")
    if topology.kind == "mesh":
        return mesh_round_shardmap_packed(table)
    if topology.name == "star":
        return star_round_shardmap_packed(table, hub=int(np.argmax(topology.degree())))
    return generic_round_shardmap_packed(table, topology.neighbors)


def data_mesh_round(
    table: ShardedTable, topology, mode: str = "reference", lean: bool = False
) -> Tuple[ShardedTable, torch.Tensor]:
    """One round of a dense data mesh (a sharded sim without shard_map),
    with the bits and counts of the unsharded round the reference's
    sharded jit computes: the lean round where ``lean_round_applies``, the
    generic gather round for a star."""
    p, n = table.shape
    if topology.kind in ("ring", "chain"):
        return ring_round_shardmap(
            table, mode, wrap=topology.kind == "ring",
            lean=lean_round_applies(lean, mode, topology.kind, p, n),
        )
    if topology.kind == "mesh":
        return mesh_round_shardmap(table, mode)
    return generic_round_shardmap(table, topology.neighbors, mode)


def ring_window_shardmap_packed(table: ShardedTable, wrap: bool, m: int):
    """``m`` ring (wrap) or chain rounds of a packed-family sharded table
    per ONE exchange of m-row slabs (the reference's
    ``ring_window_shardmap_packed``): each shard joins its extended column
    [m slab | b rows | m slab] to radius m - 1 and runs the last round
    classically, in place (``ring_window_shard_packed``: the window
    kernel's extended form on a CUDA shard, ``ring_window_shard_torch`` on
    a CPU one). The slabs are exactly m deep, so the shard's rows are
    exact; a chain's zeroed end slabs are its absent neighbours.
    Bit-identical to m classic rounds; returns (table, the round-m
    residual of the shards' own rows, summed on mesh[0]). Needs
    1 <= m <= the rows of a shard."""
    if not 1 <= m <= table.rows:
        raise ValueError(f"a window of {m} rounds needs 1 <= m <= {table.rows} rows per shard")
    parts = _parts(table, False)
    tops, bottoms = boundary_rows(parts, m, wrap, table.mesh)
    total = torch.zeros((), dtype=torch.int64, device=table.mesh[0])
    for f, top, bottom in zip(parts, tops, bottoms):
        total = total + ring_window_shard_packed(f, top, bottom, m).to(table.mesh[0])
    return table, total.to(torch.int32)


def _frontier_shardmap(
    table: ShardedTable, parts, dirty: torch.Tensor, wrap: bool, max_rounds: int,
    depth: int, tile_n: int, counts_step: Callable, window_step: Optional[Callable] = None,
):
    """Frontier convergence over a mesh, shared by the layouts: per step the
    boundary rows are exchanged (m rows each way for an m-round step),
    every shard runs its step on the active stripes of its merged fields
    ``parts``, in place, and one launch folds the shards' results into the
    next ids array. ``counts_step(fields, tops, bottoms, ids, tile_n, m,
    out=)`` gives per-round counts, summed over the shards and compacted
    (``compact_counts``); with ``window_step`` (same arguments) a
    ``depth``-round step gives window stats instead, row 0 summed and row 1
    maxed over the shards, folded by ``compact_counts_window``. The
    single-round tail of a fused loop runs ``counts_step``. Each shard's
    step writes into its row of one zeroed buffer on mesh[0], which the fold
    zeroes again as it reads it (a shard on another device copies its row
    in), and the folds write two ids buffers in turn, so that none
    overwrites the ids array its own step read. Returns (classic rounds,
    last_changed)."""
    mesh = table.mesh
    t_total = table.shape[1] // tile_n
    if depth > table.rows:
        raise ValueError(f"{depth} fused rounds need {depth} rows per shard, got {table.rows}")
    shards = len(parts)
    fold = torch.zeros(shards * max(depth, 2) * t_total, dtype=torch.int32, device=mesh[0])
    ids_bufs = [torch.empty(t_total + 3, dtype=torch.int32, device=mesh[0]) for _ in range(2)]

    def step(m: int):
        window = window_step is not None and m > 1
        rows = fold[: shards * (2 if window else m) * t_total].view(shards, -1, t_total)
        shard_step = window_step if window else counts_step

        def run(parts, ids):
            tops, bottoms = boundary_rows(parts, m, wrap, mesh)
            for row, f, top, bottom, dev in zip(rows, parts, tops, bottoms, mesh):
                if f[0].device == row.device:
                    shard_step(f, top, bottom, ids, tile_n, m, out=row)
                else:
                    row.copy_(shard_step(f, top, bottom, ids.to(dev), tile_n, m))
            ids_bufs.reverse()  # not the buffer that the last fold wrote
            if window:
                return parts, compact_counts_window(rows, m, ids_bufs[0])
            return parts, compact_counts(rows, ids_bufs[0])
        return run

    _, rounds, last_changed = frontier_loop(parts, dirty, t_total, max_rounds, depth, step)
    return rounds, last_changed


def gossip_frontier_shardmap_dense(
    table: ShardedTable, dirty: torch.Tensor, wrap: bool, mode: str, lean: bool,
    max_rounds: int, fuse: int = 1, tile_n: int = 0,
) -> Tuple[ShardedTable, int, int]:
    """Dense frontier convergence over a mesh (ring/chain), in place (see
    ``_frontier_shardmap``): ``fuse`` > 1 runs that many rounds per
    exchange (at most the rows of a shard); the classic round count is
    rebuilt exactly by the shared fused loop. Lean sims exchange and merge
    the four value keys; writer, ctr and tick stay untouched. ``dirty`` is
    a bool [t_total] seed on mesh[0]. Returns (table, classic rounds,
    last_changed)."""
    tile_n = tile_n or frontier_tile_n(table.shape[1])
    rounds, last_changed = _frontier_shardmap(
        table, _parts(table, lean), dirty, wrap, max_rounds, fuse, tile_n,
        lambda f, top, bottom, ids, tile, m, out=None: frontier_shard_round(
            f, top, bottom, ids, tile, mode, m, out),
    )
    return table, rounds, last_changed


def gossip_frontier_shardmap_packed(
    table: ShardedTable, dirty: torch.Tensor, wrap: bool, max_rounds: int, fuse: int = 1,
    window_fuse: int = 0, tile_n: int = 0,
) -> Tuple[ShardedTable, int, int]:
    """Packed-family frontier convergence over a mesh (ring/chain), in
    place (see ``_frontier_shardmap``), in one of three modes, all with the
    classic loop's final state, round count and cutoff residual:

    * ``fuse`` = 1: one round per exchange of one boundary row,
      ``frontier_shard_round_packed`` at m = 1 (#22) and ``compact_counts``;
    * ``fuse`` = HALO_FUSE: 8 rounds per exchange of 8 rows (#23) and the
      fused compaction, the tail at m = 1;
    * ``window_fuse`` = m > 1: m rounds per exchange of m-row slabs,
      ``frontier_shard_window`` (#25) and ``compact_counts_window`` (#26),
      the tail at m = 1. Row 0 of the stats counts changed entries, so a
      window step's changed total is not the classic per-round count.

    ``window_fuse`` and ``fuse`` > 1 exclude each other; either is at most
    the rows of a shard. ``dirty`` is a bool [t_total] seed on mesh[0].
    Returns (table, classic rounds, last_changed)."""
    if window_fuse > 1 and fuse > 1:
        raise ValueError("window_fuse and fuse > 1 exclude each other")
    tile_n = tile_n or frontier_tile_n(table.shape[1])
    rounds, last_changed = _frontier_shardmap(
        table, _parts(table, False), dirty, wrap, max_rounds, max(fuse, window_fuse), tile_n,
        frontier_shard_round_packed, frontier_shard_window if window_fuse > 1 else None,
    )
    return table, rounds, last_changed


def reconcile_shardmap_packed(table: ShardedTable) -> ShardedTable:
    """Direct reconcile of a packed-family sharded table, in place: every
    shard's rows become its columns' join (``reconcile_packed``), the
    shards' row 0 are joined on mesh[0] by the same function, and the join
    is written back to every row of every shard."""
    for shard in table.shards:
        reconcile_packed(shard)
    ctor = type(table.shards[0])
    joined = reconcile_packed(ctor(*(
        torch.cat([s[f][0:1].to(table.mesh[0]) for s in table.shards])
        for f in range(len(table.shards[0]))
    )))
    for shard, dev in zip(table.shards, table.mesh):
        for f, j in zip(shard, joined):
            f.copy_(j[0:1].to(dev).expand_as(f))
    return table
