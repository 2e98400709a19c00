"""Carry tables between the reference package and the port.

A reference ``TableState`` is a tuple of seven int32 [P, N] arrays, a
reference ``PackedTable`` a tuple of three, (khi, klo, cv), a ``RankTable``
two, (rank, cv), and a ``Rank1Table`` one, (rank): JAX arrays, or the numpy
arrays of a ``PeerNetworkSim.snapshot()``. A rank or rank1 snapshot's
``rank_epoch`` and ``rank_inverse`` travel beside its table; the sim's
``restore`` re-keys through them. Anything
``numpy.asarray`` accepts works, so this module needs no JAX import. A
reference table sharded over a mesh reads as its whole arrays; a port
``ShardedTable`` goes to whole arrays and back over a port mesh.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .ops.merge import FIELDS, TableState
from .ops.packed import PackedTable
from .ops.rank import Rank1Table, RankTable
from .parallel.mesh import Mesh, ShardedTable, shard_fields


def _checked(fields: Sequence, count: int):
    if len(fields) != count:
        raise ValueError(f"expected {count} fields, got {len(fields)}")
    arrays = [np.asarray(f) for f in fields]
    shape = arrays[0].shape
    for a in arrays:
        if a.dtype != np.int32 or a.ndim != 2 or a.shape != shape:
            raise ValueError(f"expected int32 {shape} fields, got {a.dtype} {a.shape}")
    return arrays


def _fields_from_numpy(fields: Sequence, count: int, device) -> Tuple[torch.Tensor, ...]:
    return tuple(_to_tensor(a, device) for a in _checked(fields, count))


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    # torch.from_numpy shares memory and must not see a read-only array
    # (a JAX array's numpy view is one); the .to() makes the device copy
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(device, copy=True)


def table_from_numpy(fields: Sequence, device) -> TableState:
    """Seven int32 [P, N] arrays -> a port TableState on ``device``. Always
    copies: the port updates tables in place."""
    return TableState(*_fields_from_numpy(fields, len(FIELDS), device))


def packed_from_numpy(fields: Sequence, device) -> PackedTable:
    """Three int32 [P, N] arrays (khi, klo, cv) -> a port PackedTable on
    ``device`` (copies)."""
    return PackedTable(*_fields_from_numpy(fields, len(PackedTable._fields), device))


def rank_from_numpy(fields: Sequence, device) -> RankTable:
    """Two int32 [P, N] arrays (rank, cv) -> a port RankTable (copies)."""
    return RankTable(*_fields_from_numpy(fields, len(RankTable._fields), device))


def rank1_from_numpy(fields: Sequence, device) -> Rank1Table:
    """One int32 [P, N] array (rank) -> a port Rank1Table (copies)."""
    return Rank1Table(*_fields_from_numpy(fields, len(Rank1Table._fields), device))


# a layout's table from numpy arrays
FROM_NUMPY = {
    "dense": table_from_numpy, "packed": packed_from_numpy,
    "rank": rank_from_numpy, "rank1": rank1_from_numpy,
}


# a layout's table type
TABLE_TYPES = {"dense": TableState, "packed": PackedTable, "rank": RankTable,
               "rank1": Rank1Table}


def sharded_from_numpy(fields: Sequence, mesh: Mesh, layout: str = "dense") -> ShardedTable:
    """A layout's int32 [P, N] arrays -> a port ShardedTable over ``mesh``
    (copies; P must split evenly over the mesh). On a mesh of processes
    each process passes the whole arrays and keeps its own shards."""
    ctor = TABLE_TYPES[layout]
    return shard_fields(_checked(fields, len(ctor._fields)), mesh, ctor)


def table_to_numpy(table) -> Tuple[np.ndarray, ...]:
    """A port table of any layout, sharded or not -> its int32 numpy arrays
    (copies). On a mesh of processes a collective: every process gets the
    whole table (see ``ShardedTable.to_numpy``)."""
    if isinstance(table, ShardedTable):
        return table.to_numpy()
    return tuple(f.detach().to("cpu", copy=True).numpy() for f in table)


packed_to_numpy = table_to_numpy
