"""Query scans over the device tables: the port of ``bullet_tpu.ops.scans``.

There is no index to maintain: ``equals``/``range``/``count`` are
compare-and-reduce scans over the columnar table, O(N) per peer row, on
whatever device the table lives. Path structure rides in three int32 [N]
tensors (parent, grandparent, last-segment id) built by the host interner
(``GraphHost.struct``).

Query shapes (matching bullet-js ``src/bullet-query.js``):

* field form -- children of ``base`` having field ``f`` with value v:
  leaf slots with grandparent == base and segment == f;
* leaf form -- direct children of ``base`` with value v.

The reference computes these as XLA programs (``jax.jit``), not Pallas
kernels, so the port computes them with PyTorch operators. Probe scalars
are Python ints or 0-d int32 tensors; every compare is on signed int32,
as the reference's. A range is inclusive at both ends and matches the
number class only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.encode import CLS_NUMBER


class PathStruct(NamedTuple):
    """Per-slot path structure, int32 [N] (-1 where absent)."""

    parent: torch.Tensor  # parent path id
    parent2: torch.Tensor  # grandparent path id
    seg: torch.Tensor  # interned id of the last path segment


class RowView(NamedTuple):
    """One replica row in the dense layout's value fields, int32 [N]
    (absent entries: cls 0, vid 0)."""

    cls: torch.Tensor
    khi: torch.Tensor
    klo: torch.Tensor
    vid: torch.Tensor


def _field_slots(struct: PathStruct, base, field) -> torch.Tensor:
    return (struct.parent2 == base) & (struct.seg == field)


def _in_range(cls, khi, klo, lo_hi, lo_lo, hi_hi, hi_lo) -> torch.Tensor:
    """Numbers whose (khi, klo) key lies in [lo, hi]: keys order float64s
    exactly, compared as signed int32 pairs."""
    ge_lo = (khi > lo_hi) | ((khi == lo_hi) & (klo >= lo_lo))
    le_hi = (khi < hi_hi) | ((khi == hi_hi) & (klo <= hi_lo))
    return (cls == CLS_NUMBER) & ge_lo & le_hi


def equals_field_mask(table, struct: PathStruct, base, field, vid) -> torch.Tensor:
    """[P, N] mask: leaf ``base/*/field`` slots whose value id equals vid."""
    return _field_slots(struct, base, field)[None, :] & (table.vid == vid)


def equals_leaf_mask(table, struct: PathStruct, base, vid) -> torch.Tensor:
    """[P, N] mask: direct-child leaves of ``base`` whose value id equals vid."""
    return (struct.parent == base)[None, :] & (table.vid == vid)


def range_field_mask(table, struct: PathStruct, base, field,
                     lo_hi, lo_lo, hi_hi, hi_lo) -> torch.Tensor:
    """[P, N] mask: numeric values in [lo, hi] (inclusive), field form.
    Bounds are (khi, klo) encoded keys."""
    return _field_slots(struct, base, field)[None, :] & _in_range(
        table.cls, table.khi, table.klo, lo_hi, lo_lo, hi_hi, hi_lo)


def range_leaf_mask(table, struct: PathStruct, base,
                    lo_hi, lo_lo, hi_hi, hi_lo) -> torch.Tensor:
    return (struct.parent == base)[None, :] & _in_range(
        table.cls, table.khi, table.klo, lo_hi, lo_lo, hi_hi, hi_lo)


def count_mask(mask: torch.Tensor) -> torch.Tensor:
    """Matches per row, int32."""
    return mask.sum(dim=-1, dtype=torch.int32)


# --------------------------------------------------------- single-peer rows
# Per-peer queries slice one replica row first: O(N) instead of O(P N).


def peer_row(table, peer) -> RowView:
    """Row ``peer`` of a dense table as a RowView (views, no copies)."""
    return RowView(table.cls[peer], table.khi[peer], table.klo[peer], table.vid[peer])


def equals_field_mask_row(row: RowView, struct: PathStruct, base, field, vid) -> torch.Tensor:
    return _field_slots(struct, base, field) & (row.vid == vid)


def equals_leaf_mask_row(row: RowView, struct: PathStruct, base, vid) -> torch.Tensor:
    return (struct.parent == base) & (row.vid == vid)


def range_field_mask_row(row: RowView, struct: PathStruct, base, field,
                         lo_hi, lo_lo, hi_hi, hi_lo) -> torch.Tensor:
    return _field_slots(struct, base, field) & _in_range(
        row.cls, row.khi, row.klo, lo_hi, lo_lo, hi_hi, hi_lo)


def range_leaf_mask_row(row: RowView, struct: PathStruct, base,
                        lo_hi, lo_lo, hi_hi, hi_lo) -> torch.Tensor:
    return (struct.parent == base) & _in_range(
        row.cls, row.khi, row.klo, lo_hi, lo_lo, hi_hi, hi_lo)


def equals_field_count_row(row: RowView, struct: PathStruct, base, field, vid) -> torch.Tensor:
    """Scalar match count (int32 0-d): ``count`` reads back this one
    scalar instead of the [N] mask that ``equals`` needs."""
    return count_mask(equals_field_mask_row(row, struct, base, field, vid))


def equals_leaf_count_row(row: RowView, struct: PathStruct, base, vid) -> torch.Tensor:
    return count_mask(equals_leaf_mask_row(row, struct, base, vid))


def subtree_leaf_mask(table, member: torch.Tensor) -> torch.Tensor:
    """[P, N] mask of present leaves restricted to a membership mask [N]
    (host-computed descendants of a path)."""
    return member[None, :] & (table.cls > 0)


# ------------------------------------------------------- rank-native rows
# The rank1 layout's queries skip the RowView rebuild: ranks are strictly
# monotone in (cls, khi, klo, vid), so value equality is one rank compare
# and a numeric range one rank interval (bounds from RankIndex.rank_bounds).


def equals_field_mask_rank(rank_row, struct: PathStruct, base, field, rank) -> torch.Tensor:
    return _field_slots(struct, base, field) & (rank_row == rank)


def equals_leaf_mask_rank(rank_row, struct: PathStruct, base, rank) -> torch.Tensor:
    return (struct.parent == base) & (rank_row == rank)


def range_field_mask_rank(rank_row, struct: PathStruct, base, field,
                          lo_rank, hi_rank) -> torch.Tensor:
    return _field_slots(struct, base, field) & (rank_row >= lo_rank) & (rank_row <= hi_rank)


def range_leaf_mask_rank(rank_row, struct: PathStruct, base, lo_rank, hi_rank) -> torch.Tensor:
    return (struct.parent == base) & (rank_row >= lo_rank) & (rank_row <= hi_rank)


def equals_field_count_rank(rank_row, struct: PathStruct, base, field, rank) -> torch.Tensor:
    return count_mask(equals_field_mask_rank(rank_row, struct, base, field, rank))


def equals_leaf_count_rank(rank_row, struct: PathStruct, base, rank) -> torch.Tensor:
    return count_mask(equals_leaf_mask_rank(rank_row, struct, base, rank))
