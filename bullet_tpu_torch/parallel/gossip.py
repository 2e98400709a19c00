"""Gossip rounds: topology-shaped neighbour exchange + semilattice merge.

One synchronous round delivers every peer the merge of its neighbours'
tables; because the merge is a join-semilattice, rounds reach the fixed
point in at most diameter rounds, deterministically.

Ring and chain rounds run ``ring_round`` (``ring_round_lean`` for lean
gossip where the reference takes its lean kernel) and the mesh and generic
rounds run ``merge_tables``: the CUDA kernels on CUDA tensors, their plain
PyTorch versions on CPU tensors. ``parallel/shardmap_gossip.py`` holds the
same rounds on a sharded table, a data mesh's (no ``use_shard_map``) and
a mesh of processes' among them.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.merge import TableState, lean_fields, merge_lean, merge_tables
from ..ops.ring_kernel import lean_supported, ring_round, ring_round_lean
from .topology import Topology


def _roll(table: TableState, shift: int) -> TableState:
    return TableState(*(torch.roll(f, shift, 0) for f in table))


def _mask_rows(table: TableState, valid: torch.Tensor) -> TableState:
    """Invalidate rows (make them ABSENT so they lose every merge)."""
    valid = valid[:, None]
    return TableState(*(torch.where(valid, f, torch.zeros_like(f)) for f in table))


def gossip_round_ring(table: TableState, mode: str) -> Tuple[TableState, torch.Tensor]:
    """Ring: receive from both neighbours (in place)."""
    return ring_round(table, mode, wrap=True)


def gossip_round_chain(table: TableState, mode: str) -> Tuple[TableState, torch.Tensor]:
    """Chain: ring shifts with the wrap-around rows replaced by all-zero
    (ABSENT) rows (in place)."""
    return ring_round(table, mode, wrap=False)


def gossip_round_mesh(
    table: TableState, mode: str, lean: bool = False
) -> Tuple[TableState, torch.Tensor]:
    """Full mesh: one round makes everyone equal. Recursive doubling —
    ceil(log2 P) shifted merges; idempotence makes the overlap harmless.
    ``lean`` joins the four value keys only, in place (the lean reconcile;
    writer, ctr and tick stay local)."""
    num_peers = table.cls.shape[0]
    total = torch.zeros((), dtype=torch.int32, device=table.cls.device)
    for k in range(max(1, (num_peers - 1).bit_length())):
        if lean:
            keys = lean_fields(table)
            c = merge_lean(keys, [torch.roll(f, 1 << k, 0) for f in keys])
        else:
            table, c = merge_tables(table, _roll(table, 1 << k), mode)
        total = total + c
    return table, total


def gossip_round_generic(
    table: TableState, neighbors: torch.Tensor, mode: str
) -> Tuple[TableState, torch.Tensor]:
    """Arbitrary adjacency: gather each neighbour column and merge.
    ``neighbors`` is [P, max_deg] with -1 padding; padded entries are
    masked to ABSENT and cannot win."""
    total = torch.zeros((), dtype=torch.int32, device=table.cls.device)
    for k in range(neighbors.shape[1]):
        idx = neighbors[:, k]
        valid = idx >= 0
        safe = torch.where(valid, idx, torch.zeros_like(idx))
        gathered = _mask_rows(TableState(*(f[safe] for f in table)), valid)
        table, c = merge_tables(table, gathered, mode)
        total = total + c
    return table, total


def lean_round_applies(lean: bool, mode: str, kind: str, p: int, n: int) -> bool:
    """Whether a round of ``kind`` at [p, n] is the lean round: lean gossip
    on the kernel route, reference mode, a ring or chain, and a shape the
    reference's lean kernel takes (``parallel/gossip.py:153``); every other
    round merges all seven fields, as the reference's do."""
    return lean and mode == "reference" and kind in ("ring", "chain") and lean_supported(p, n)


def gossip_round(
    table: TableState,
    topology: Topology,
    mode: str = "reference",
    lean: bool = False,
) -> Tuple[TableState, torch.Tensor]:
    """One synchronous gossip round; returns (table, changed_count). Ring
    and chain rounds update the table in place. ``lean`` is lean gossip on
    the kernel route (the reference's ``use_pallas``): see
    ``lean_round_applies``."""
    kind = topology.kind
    if lean_round_applies(lean, mode, kind, *table.cls.shape):
        return ring_round_lean(table, wrap=kind == "ring")
    if kind == "ring":
        return gossip_round_ring(table, mode)
    if kind == "chain":
        return gossip_round_chain(table, mode)
    if kind == "mesh":
        return gossip_round_mesh(table, mode)
    neighbors = torch.as_tensor(topology.neighbors, device=table.cls.device).to(torch.int64)
    return gossip_round_generic(table, neighbors, mode)


def until_converged(round_fn: Callable, table, max_rounds: int) -> Tuple[object, int, int]:
    """Run ``table, changed = round_fn(table)`` until the residual hits
    zero (bounded by ``max_rounds``), reading one scalar per round. Returns
    (table, rounds, last_changed): last_changed == 0 iff the fixed point
    was reached (vs the round cap); the initial sentinel 1 only survives
    when max_rounds == 0."""
    rounds = 0
    last_changed = 1
    while rounds < max_rounds and last_changed > 0:
        table, changed = round_fn(table)
        rounds += 1
        last_changed = int(changed)
    return table, rounds, last_changed


def gossip_until_converged(
    table: TableState,
    topology: Topology,
    mode: str,
    max_rounds: int,
    lean: bool = False,
) -> Tuple[TableState, int, int]:
    """``gossip_round`` until the residual hits zero (see
    ``until_converged``)."""
    return until_converged(
        lambda t: gossip_round(t, topology, mode, lean), table, max_rounds
    )
