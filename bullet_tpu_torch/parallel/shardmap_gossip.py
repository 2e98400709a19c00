"""Explicit SPMD gossip on a sharded table.

The port of ``bullet_tpu.parallel.shardmap_gossip``: per-shard local merges
plus hand-placed exchanges between the shards of a ``ShardedTable``, for
the dense layout (full or lean) and the packed family (packed, rank,
rank1). The reference ran one ``shard_map`` program, under one
controller or, across hosts, its multi-controller runtime; here one
process drives its own shards, and a mesh may span processes
(``parallel/multihost.py``). The reference's ``ppermute`` becomes a
``copy_`` of the boundary rows into the neighbour shard's device, or a
send to the process that owns it (``mesh.transfer``); its ``psum`` of
the frontier's counts (``pmax``) a fold of the shards' rows of one
buffer, summed over the processes (rows are disjoint) and folded inside
the compaction's launch on every process alike; its ``all_gather`` a
transfer of the rows a shard needs. Counts are summed over the
processes, so every process returns the same counts and round counts
and takes the same branches: every function here is a collective on a
mesh of processes.

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
from .mesh import Mesh, ShardedTable, all_sum, as_mesh, disjoint_sum, transfer

# rounds one boundary exchange buys the fused frontier (the reference's
# HALO_FUSE: the 8-row boundary snapshots)
HALO_FUSE = 8

# merge(shard, fields) -> (merged shard, count): a shard's merge with rows
# of its merged fields (every field, or a lean shard's four value keys)
Merge = Callable[[object, Sequence[torch.Tensor]], Tuple[object, torch.Tensor]]


def _parts(table: ShardedTable, lean: bool) -> List[Optional[Tuple[torch.Tensor, ...]]]:
    """Each shard's merged fields: the four value keys (lean) or all; None
    for the shards of other processes."""
    return [None if s is None else lean_fields(s) if lean else tuple(s) for s in table.shards]


def _local_part(parts):
    return next(p for p in parts if p is not None)


def boundary_rows(parts, s: int, wrap: bool, mesh: Mesh):
    """The s rows above (tops) and below (bottoms) every shard of this
    process, copied onto the shard's device (None for other processes'
    shards): shard i's tops are the last s rows of shard i - 1, its bottoms
    the first s rows of shard i + 1, wrapping around the mesh, sent by
    their owner where it is another process; on a chain the first shard's
    tops and the last shard's bottoms are zeros. Every copy is taken before
    the caller writes any shard."""
    mesh = as_mesh(mesh)
    k = len(parts)
    nf, n = len(_local_part(parts)), _local_part(parts)[0].shape[1]
    jobs, where = [], []
    for i in range(k):
        if wrap or i > 0:
            j = (i - 1) % k
            jobs.append((j, i, s, lambda j=j: [f[-s:] for f in parts[j]]))
            where.append((i, 0))
        if wrap or i < k - 1:
            j = (i + 1) % k
            jobs.append((j, i, s, lambda j=j: [f[:s] for f in parts[j]]))
            where.append((i, 1))
    got = transfer(mesh, jobs, nf, n)
    ends: List[List[Optional[list]]] = [[None] * k, [None] * k]
    for job, (i, side) in enumerate(where):
        if job in got:
            ends[side][i] = got[job]
    for i in mesh.local:
        for side in (0, 1):
            if ends[side][i] is None:  # a chain's end
                ends[side][i] = [torch.zeros((s, n), dtype=f.dtype, device=mesh[i])
                                 for f in parts[i]]
    return ends[0], ends[1]


def _zero_count(mesh: Mesh) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=mesh.home)


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
    (table, changed) with the count summed on mesh.home over every
    shard."""
    mesh = table.mesh
    tops, bottoms = boundary_rows(parts, 1, wrap, mesh)
    total = _zero_count(mesh)
    tile_n = frontier_tile_n(table.shape[1])
    if tile_n:
        t_total = table.shape[1] // tile_n
        for i in mesh.local:
            ids = torch.arange(t_total + 2, dtype=torch.int32, device=mesh[i])
            ids[t_total] = t_total
            counts = shard_step(parts[i], tops[i], bottoms[i], ids, tile_n)
            total = total + counts.sum(dtype=torch.int32).to(mesh.home)
        return table, all_sum(mesh, total)
    shards = list(table.shards)
    for i in mesh.local:
        up = [torch.cat([t, x[:-1]]) for x, t in zip(parts[i], tops[i])]
        down = [torch.cat([x[1:], bo]) for x, bo in zip(parts[i], bottoms[i])]
        shard, c1 = merge(shards[i], up)
        shards[i], c2 = merge(shard, down)
        total = total + (c1 + c2).to(mesh.home)
    return ShardedTable(shards, mesh), all_sum(mesh, total)


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


def _global_roll(parts, s: int, mesh: Mesh) -> List[Optional[List[torch.Tensor]]]:
    """``torch.roll(·, s, 0)`` of the whole table, per shard of this
    process on its own device: rows hop ``s // b`` whole shards, and the
    ``s % b`` remainder splices the boundary between two hopped blocks."""
    k = len(parts)
    local = _local_part(parts)
    nf, (b, n) = len(local), local[0].shape
    d, r = divmod(s % (k * b), b)
    jobs = []
    for j in range(k):
        src = (j - d) % k
        jobs.append((src, j, b - r, lambda src=src: [f[:b - r] for f in parts[src]]))
        if r:
            src1 = (j - d - 1) % k
            jobs.append((src1, j, r, lambda src1=src1: [f[b - r:] for f in parts[src1]]))
    got = transfer(mesh, jobs, nf, n, copy=r == 0)
    out: List[Optional[List[torch.Tensor]]] = [None] * k
    per = 2 if r else 1
    for j in mesh.local:
        if r == 0:
            out[j] = got[j]
        else:
            from_d, from_d1 = got[per * j], got[per * j + 1]
            out[j] = [torch.cat([f1, f0]) for f0, f1 in zip(from_d, from_d1)]
    return out


def _merge_local(table: ShardedTable, rows, merge: Merge, total: torch.Tensor):
    """Every shard of this process merged with its ``rows``; the counts
    added to ``total`` on mesh.home."""
    shards = list(table.shards)
    for i in table.mesh.local:
        shards[i], c = merge(shards[i], rows[i])
        total = total + c.to(table.mesh.home)
    return ShardedTable(shards, table.mesh), total


def _mesh_doubling(table: ShardedTable, lean: bool, merge: Merge):
    """Recursive doubling over global rolls of the shards' merged fields;
    each step takes every shard's rolled rows before it merges any."""
    p = table.shape[0]
    total = _zero_count(table.mesh)
    for k in range(max(1, (p - 1).bit_length())):
        rolled = _global_roll(_parts(table, lean), 1 << k, table.mesh)
        table, total = _merge_local(table, rolled, merge, total)
    return table, all_sum(table.mesh, total)


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
    the shards' maxima, which every process holds). Values are the
    unsharded generic round's; the count is the strict-improvement count
    against the pre-round hub (zero iff the unsharded count is zero)."""
    mesh, b, n = table.mesh, table.rows, table.shape[1]
    ctor = type(table.first)
    nf = len(table.first)
    hub_shard, hub_row = divmod(hub, b)
    hub_old = ctor(*table.take_rows([hub], mesh.home))
    maxima = disjoint_sum(mesh, {
        i: torch.stack([f[0] for f in _row_max(s, merge)]) for i, s in table.local()
    }, (nf, n))
    gmax = _row_max(ctor(*(maxima[:, f].contiguous() for f in range(nf))), merge)
    new_hub, c_hub = merge(hub_old, gmax)
    total = c_hub if mesh.owns(hub_shard) else _zero_count(mesh)
    rows = [None if s is None else [f.to(mesh[i]).expand(b, n).contiguous() for f in hub_old]
            for i, s in enumerate(table.shards)]
    table, total = _merge_local(table, rows, merge, total)
    if mesh.owns(hub_shard):
        for f, h in zip(table.shards[hub_shard], new_hub):
            f[hub_row] = h[0]
    return table, all_sum(mesh, total)


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
    rows from their shards (padding left as all-zero rows, which never
    win), then merges them; bit-identical to the unsharded generic round
    including counts."""
    mesh, b = table.mesh, table.rows
    k_shards, (p, n) = len(mesh), table.shape
    total = _zero_count(mesh)
    for k in range(neighbors.shape[1]):
        parts = _parts(table, False)
        nf = len(_local_part(parts))
        jobs, where = [], []
        for i in range(k_shards):
            col = neighbors[i * b:(i + 1) * b, k]
            for j in range(k_shards):
                sel = np.flatnonzero((col >= 0) & (col // b == j))
                if not len(sel):
                    continue
                rows = col[sel] - j * b
                jobs.append((j, i, len(sel), lambda j=j, rows=rows: [
                    f.index_select(0, torch.from_numpy(rows).to(f.device)) for f in parts[j]]))
                where.append((i, sel))
        got = transfer(mesh, jobs, nf, n, copy=False)
        gathered: List[Optional[List[torch.Tensor]]] = [None] * k_shards
        for i in mesh.local:
            gathered[i] = [torch.zeros((b, n), dtype=torch.int32, device=mesh[i])
                           for _ in range(nf)]
        for job, (i, sel) in enumerate(where):
            if job in got:
                dst = torch.from_numpy(sel).to(mesh[i])
                for g, block in zip(gathered[i], got[job]):
                    g[dst] = block
        table, total = _merge_local(table, gathered, merge, total)
    return table, all_sum(mesh, total)


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
    residual of the shards' own rows, summed on mesh.home over every
    shard). Needs 1 <= m <= the rows of a shard."""
    if not 1 <= m <= table.rows:
        raise ValueError(f"a window of {m} rounds needs 1 <= m <= {table.rows} rows per shard")
    mesh = table.mesh
    parts = _parts(table, False)
    tops, bottoms = boundary_rows(parts, m, wrap, mesh)
    total = torch.zeros((), dtype=torch.int64, device=mesh.home)
    for i in mesh.local:
        total = total + ring_window_shard_packed(parts[i], tops[i], bottoms[i], m).to(mesh.home)
    return table, all_sum(mesh, total).to(torch.int32)


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
    step writes into its row of one zeroed [S, ., t_total] buffer on its
    device, the buffers of this process's other devices are added into
    mesh.home's, and the rows are summed over the processes (they are
    disjoint: each process wrote its own shards' rows), so every process
    folds the same buffer into the same ids array, reads the same counts
    and takes the same branch. The fold zeroes the buffer again as it
    reads it, and the folds write two ids buffers in turn, so that none
    overwrites the ids array its own step read. Returns (classic rounds,
    last_changed)."""
    mesh = table.mesh
    home = mesh.home
    t_total = table.shape[1] // tile_n
    if depth > table.rows:
        raise ValueError(f"{depth} fused rounds need {depth} rows per shard, got {table.rows}")
    shards = len(parts)
    size = shards * max(depth, 2) * t_total
    fold = {dev: torch.zeros(size, dtype=torch.int32, device=dev)
            for dev in dict.fromkeys(mesh[i] for i in mesh.local)}
    ids_bufs = [torch.empty(t_total + 3, dtype=torch.int32, device=home) for _ in range(2)]

    def step(m: int):
        window = window_step is not None and m > 1
        rows = {dev: buf[: shards * (2 if window else m) * t_total].view(shards, -1, t_total)
                for dev, buf in fold.items()}
        shard_step = window_step if window else counts_step

        def run(parts, ids):
            tops, bottoms = boundary_rows(parts, m, wrap, mesh)
            for i in mesh.local:
                dev = mesh[i]
                shard_step(parts[i], tops[i], bottoms[i], ids if dev == home else ids.to(dev),
                           tile_n, m, out=rows[dev][i])
            for dev, other in rows.items():
                if dev != home:  # a card of this process besides home
                    rows[home] += other.to(home)
                    other.zero_()
            all_sum(mesh, rows[home])
            ids_bufs.reverse()  # not the buffer that the last fold wrote
            if window:
                return parts, compact_counts_window(rows[home], m, ids_bufs[0])
            return parts, compact_counts(rows[home], ids_bufs[0])
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
    a bool [t_total] seed on mesh.home, the same on every process. Returns
    (table, classic rounds, last_changed)."""
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
    the rows of a shard. ``dirty`` is a bool [t_total] seed on mesh.home,
    the same on every process. Returns (table, classic rounds,
    last_changed)."""
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
    shards' row 0 are gathered to every process (one disjoint sum) and
    joined on mesh.home by the same function, and each process writes the
    join back to every row of its shards."""
    mesh = table.mesh
    for _, shard in table.local():
        reconcile_packed(shard)
    ctor, nf = type(table.first), len(table.first)
    firsts = disjoint_sum(mesh, {i: torch.stack([f[0] for f in s]) for i, s in table.local()},
                          (nf, table.shape[1]))
    joined = reconcile_packed(ctor(*(firsts[:, f].contiguous() for f in range(nf))))
    for i, shard in table.local():
        for f, j in zip(shard, joined):
            f.copy_(j[0:1].to(mesh[i]).expand_as(f))
    return table
