"""Explicit SPMD gossip on a sharded dense table.

The port of the dense parts of ``bullet_tpu.parallel.shardmap_gossip``:
per-shard local merges plus hand-placed exchanges between the shards of a
``ShardedTable``. The reference ran one ``shard_map`` program under a
single controller; here one process drives every shard. Its
``ppermute`` becomes a ``copy_`` of the boundary rows into the neighbour
shard's device, its ``psum`` a sum of the shards' count tensors on the
mesh's first device, its ``all_gather`` a copy of the rows a shard needs.

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
* the dense frontier — per-shard frontier steps (``frontier_shard.cu``)
  between boundary exchanges, the shards' counts summed and compacted
  (``compact_counts.cu``) into the next step's ids array.

Every merge runs the kernels on CUDA tensors and their plain versions on
CPU tensors. A round returns a new ``ShardedTable`` whose shards may be the
old ones updated in place.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.merge import TableState, lean_fields, merge_lean, merge_tables
from ..ops.packed import compact_counts, frontier_loop
from ..ops.ring_kernel import frontier_shard_round, frontier_tile_n
from .gossip import lean_round_applies
from .mesh import Mesh, ShardedTable

# rounds one boundary exchange buys the fused frontier (the reference's
# HALO_FUSE: the 8-row boundary snapshots)
HALO_FUSE = 8


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


def _merge(a, b: Sequence[torch.Tensor], mode: str, lean: bool):
    """(merged shard, count): the lean merge in place into ``a``'s value
    keys, or the full merge into a new table."""
    if lean:
        return a, merge_lean(lean_fields(a), b)
    return merge_tables(a, TableState(*b), mode)


def ring_round_shardmap(
    table: ShardedTable, mode: str = "reference", wrap: bool = True, lean: bool = False
) -> Tuple[ShardedTable, torch.Tensor]:
    """One ring (wrap) or chain round: each shard merges its rows shifted
    by one with the exchanged boundary row filling the gap, up then down,
    from the pre-round rows. ``lean`` merges the four value keys. Where
    the frontier stripes the slots this is the per-shard frontier step at
    m = 1 over every stripe, in place; otherwise each shard merges shifted
    copies. Returns (table, changed) with the count summed on mesh[0]."""
    parts = _parts(table, lean)
    tops, bottoms = boundary_rows(parts, 1, wrap, table.mesh)
    total = _zero_count(table.mesh)
    tile_n = frontier_tile_n(table.shape[1])
    if tile_n:
        t_total = table.shape[1] // tile_n
        for f, top, bottom, dev in zip(parts, tops, bottoms, table.mesh):
            ids = torch.arange(t_total + 2, dtype=torch.int32, device=dev)
            ids[t_total] = t_total
            counts = frontier_shard_round(f, top, bottom, ids, tile_n, mode, 1)
            total = total + counts.sum(dtype=torch.int32).to(table.mesh[0])
        return table, total
    shards = []
    for shard, f, top, bottom in zip(table.shards, parts, tops, bottoms):
        up = [torch.cat([t, x[:-1]]) for x, t in zip(f, top)]
        down = [torch.cat([x[1:], bo]) for x, bo in zip(f, bottom)]
        shard, c1 = _merge(shard, up, mode, lean)
        shard, c2 = _merge(shard, down, mode, lean)
        shards.append(shard)
        total = total + (c1 + c2).to(table.mesh[0])
    return ShardedTable(shards, table.mesh), total


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


def mesh_round_shardmap(
    table: ShardedTable, mode: str = "reference", lean: bool = False
) -> Tuple[ShardedTable, torch.Tensor]:
    """One full-mesh round by recursive doubling over global rolls:
    bit-identical to ``gossip_round_mesh`` (``lean`` as its lean join, the
    reconcile of a lean sim). Each step takes every shard's rolled rows
    before it merges any."""
    p = table.shape[0]
    total = _zero_count(table.mesh)
    for k in range(max(1, (p - 1).bit_length())):
        rolled = _global_roll(_parts(table, lean), 1 << k, table.mesh)
        shards = []
        for shard, rows in zip(table.shards, rolled):
            shard, c = _merge(shard, rows, mode, lean)
            shards.append(shard)
            total = total + c.to(table.mesh[0])
        table = ShardedTable(shards, table.mesh)
    return table, total


def _row_max(rows: TableState, mode: str) -> TableState:
    """The lexmax of [r, N] rows as one row, keeping the earliest row on
    equal keys (the reference's sequential row-by-row merge): pairwise
    halving, the lower rows always the first operand."""
    while rows.cls.shape[0] > 1:
        r = rows.cls.shape[0]
        half = r // 2
        merged, _ = merge_tables(
            TableState(*(f[0:2 * half:2].contiguous() for f in rows)),
            TableState(*(f[1:2 * half:2].contiguous() for f in rows)), mode,
        )
        if r % 2:
            merged = TableState(*(torch.cat([m, f[r - 1:]]) for m, f in zip(merged, rows)))
        rows = merged
    return rows


def star_round_shardmap(
    table: ShardedTable, mode: str = "reference", hub: int = 0
) -> Tuple[ShardedTable, torch.Tensor]:
    """One star round: every row merges the hub's pre-round row, and the
    hub becomes the lattice max of all rows (each shard's max, then across
    shards on the hub's device). Values are the unsharded generic round's;
    the count is the strict-improvement count against the pre-round hub
    (zero iff the unsharded count is zero)."""
    b = table.rows
    hub_dev, hub_row = divmod(hub, b)
    hub_shard = table.shards[hub_dev]
    hub_device = table.mesh[hub_dev]
    hub_old = TableState(*(f[hub_row:hub_row + 1].clone() for f in hub_shard))
    maxima = [
        TableState(*(f.to(hub_device) for f in _row_max(s, mode)))
        for s in table.shards
    ]
    gmax = _row_max(TableState(*(torch.cat(fs) for fs in zip(*maxima))), mode)
    new_hub, c_hub = merge_tables(hub_old, gmax, mode)
    total = c_hub.to(table.mesh[0])
    shards = []
    for shard, dev in zip(table.shards, table.mesh):
        bcast = [f.to(dev).expand(b, f.shape[1]).contiguous() for f in hub_old]
        merged, c = merge_tables(shard, TableState(*bcast), mode)
        shards.append(merged)
        total = total + c.to(table.mesh[0])
    for f, h in zip(shards[hub_dev], new_hub):
        f[hub_row] = h[0]
    return ShardedTable(shards, table.mesh), total


def generic_round_shardmap(
    table: ShardedTable, neighbors: np.ndarray, mode: str = "reference"
) -> Tuple[ShardedTable, torch.Tensor]:
    """One round over an arbitrary adjacency ([P, max_deg], -1 padding):
    per neighbour column every shard takes its peers' neighbours' current
    rows from their shards (padding masked to all-zero rows, which never
    win), then merges them; bit-identical to ``gossip_round_generic``
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
            shard, c = merge_tables(shard, TableState(*rows), mode)
            shards.append(shard)
            total = total + c.to(table.mesh[0])
        table = ShardedTable(shards, table.mesh)
    return table, total


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


def data_mesh_round(
    table: ShardedTable, topology, mode: str = "reference", lean: bool = False
) -> Tuple[ShardedTable, torch.Tensor]:
    """One round of a data mesh (a sharded sim without shard_map), with the
    bits and counts of the unsharded round the reference's sharded jit
    computes: the lean round where ``lean_round_applies``, the generic
    gather round for a star."""
    p, n = table.shape
    if topology.kind in ("ring", "chain"):
        return ring_round_shardmap(
            table, mode, wrap=topology.kind == "ring",
            lean=lean_round_applies(lean, mode, topology.kind, p, n),
        )
    if topology.kind == "mesh":
        return mesh_round_shardmap(table, mode)
    return generic_round_shardmap(table, topology.neighbors, mode)


def gossip_frontier_shardmap_dense(
    table: ShardedTable, dirty: torch.Tensor, wrap: bool, mode: str, lean: bool,
    max_rounds: int, fuse: int = 1, tile_n: int = 0,
) -> Tuple[ShardedTable, int, int]:
    """Dense frontier convergence over a mesh (ring/chain), in place: per
    step the boundary rows are exchanged (1 row each way, ``fuse`` rows for
    a fused step), every shard runs its frontier step on the active stripes,
    and the shards' counts, summed on mesh[0], compact into the next ids
    array. ``fuse`` > 1 runs that many rounds per exchange (at most the
    rows of a shard); the classic round count is rebuilt exactly by the
    shared fused loop. Lean sims exchange and merge the four value keys;
    writer, ctr and tick stay untouched. ``dirty`` is a bool [t_total]
    seed on mesh[0]. Returns (table, classic rounds, last_changed)."""
    mesh = table.mesh
    tile_n = tile_n or frontier_tile_n(table.shape[1])
    t_total = table.shape[1] // tile_n
    if fuse > table.rows:
        raise ValueError(f"{fuse} fused rounds need {fuse} rows per shard, got {table.rows}")

    def step(m: int):
        def run(parts, ids):
            tops, bottoms = boundary_rows(parts, m, wrap, mesh)
            total = torch.zeros((m, t_total), dtype=torch.int32, device=mesh[0])
            for f, top, bottom, dev in zip(parts, tops, bottoms, mesh):
                counts = frontier_shard_round(f, top, bottom, ids.to(dev), tile_n, mode, m)
                total = total + counts.to(mesh[0])
            return parts, compact_counts(total)
        return run

    _, rounds, last_changed = frontier_loop(_parts(table, lean), dirty, t_total, max_rounds,
                                            fuse, step)
    return table, rounds, last_changed
