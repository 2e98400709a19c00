"""Device mesh and sharded tables for the peer axis.

The port of ``bullet_tpu.parallel.mesh``. A mesh is a tuple of
``torch.device``s, one per shard; a device may repeat, so k shards can
live on one card (or on the CPU: the counterpart of XLA's forced host
device count). A ``ShardedTable`` splits a table's peer rows evenly over
the mesh: shard i holds rows [i b, (i + 1) b) on mesh[i], as its own
table of the layout's type. Nothing gathers a whole sharded table onto one
device: reads take the rows they need from the owning shards, and only
``to_numpy`` (snapshots, equality checks in tests) assembles it, on the
host.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

Mesh = Tuple[torch.device, ...]


def make_mesh(num_devices: int, device="cuda") -> Mesh:
    """The first ``num_devices`` devices of ``device``'s type. On the CPU,
    ``num_devices`` virtual shards of the one CPU device; on CUDA it
    raises when fewer cards are visible (it never shrinks silently)."""
    device = torch.device(device)
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {num_devices}")
    if device.type == "cpu":
        return (torch.device("cpu"),) * num_devices
    if device.type != "cuda":
        raise ValueError(f"no mesh over {device.type} devices")
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(f"a mesh of {num_devices} CUDA devices, but {visible} are visible")
    return tuple(torch.device("cuda", i) for i in range(num_devices))


def resolve_mesh(mesh_devices: Union[int, Sequence], device) -> Mesh:
    """A mesh from an int (``make_mesh`` over ``device``'s type) or an
    explicit sequence of devices, in which one device may repeat."""
    if isinstance(mesh_devices, int):
        return make_mesh(mesh_devices, device)
    mesh = tuple(torch.device(d) for d in mesh_devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pad_peers_to_mesh(num_peers: int, mesh: Mesh) -> int:
    """Smallest peer count >= num_peers divisible by the mesh size."""
    n = len(mesh)
    return ((num_peers + n - 1) // n) * n


class ShardedTable:
    """A table split by peer rows over a mesh: ``shards[i]`` is a table of
    the layout's type holding rows [i b, (i + 1) b) on ``mesh[i]``."""

    def __init__(self, shards: Sequence, mesh: Mesh) -> None:
        if len(shards) != len(mesh):
            raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
        self.shards: List = list(shards)
        self.mesh: Mesh = tuple(mesh)

    @property
    def rows(self) -> int:
        """Peer rows per shard."""
        return self.shards[0][0].shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        """(P, N) of the whole table."""
        return self.rows * len(self.shards), self.shards[0][0].shape[1]

    def map(self, fn: Callable) -> "ShardedTable":
        """A sharded table of ``fn(shard)`` for every shard."""
        return ShardedTable([fn(s) for s in self.shards], self.mesh)

    def owner(self, peers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(shard index, local row) of global peer rows."""
        return np.divmod(np.asarray(peers, dtype=np.int64), self.rows)

    def take_rows(self, peers: np.ndarray, device, fields=None) -> List[torch.Tensor]:
        """The global rows ``peers`` (any order, repeats allowed) of every
        field (or of the field indices ``fields``), as [len(peers), N]
        tensors on ``device``, copied from the owning shards."""
        peers = np.asarray(peers, dtype=np.int64)
        which = range(len(self.shards[0])) if fields is None else fields
        n = self.shape[1]
        out = [torch.zeros((len(peers), n), dtype=torch.int32, device=device) for _ in which]
        shard, local = self.owner(peers)
        for i, s in enumerate(self.shards):
            sel = np.flatnonzero(shard == i)
            if not len(sel):
                continue
            src = torch.from_numpy(local[sel]).to(self.mesh[i])
            dst = torch.from_numpy(sel).to(device)
            for o, f in zip(out, which):
                o[dst] = s[f].index_select(0, src).to(device)
        return out

    def put_rows(self, peers: np.ndarray, rows: Sequence[torch.Tensor], fields=None) -> None:
        """Write [len(peers), N] ``rows`` (of every field, or of the field
        indices ``fields``) into the global rows ``peers``, in place."""
        peers = np.asarray(peers, dtype=np.int64)
        which = range(len(self.shards[0])) if fields is None else fields
        shard, local = self.owner(peers)
        for i, s in enumerate(self.shards):
            sel = np.flatnonzero(shard == i)
            if not len(sel):
                continue
            dev = self.mesh[i]
            dst = torch.from_numpy(local[sel]).to(dev)
            for r, f in zip(rows, which):
                s[f][dst] = r[torch.from_numpy(sel).to(r.device)].to(dev)

    def gather(self, peers: np.ndarray, slots: np.ndarray, fields: Sequence[int]) -> List[np.ndarray]:
        """The entries at the K (peer, slot) pairs of the field indices
        ``fields``, as numpy arrays, one device gather per shard and
        field."""
        peers = np.asarray(peers, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        out = [np.zeros(len(peers), dtype=np.int32) for _ in fields]
        shard, local = self.owner(peers)
        for i, s in enumerate(self.shards):
            sel = np.flatnonzero(shard == i)
            if not len(sel):
                continue
            idx = tuple(torch.from_numpy(a[sel]).to(self.mesh[i]) for a in (local, slots))
            for o, f in zip(out, fields):
                o[sel] = s[f][idx].cpu().numpy()
        return out

    def to_numpy(self) -> Tuple[np.ndarray, ...]:
        """Every field of the whole table as int32 [P, N] host arrays."""
        return tuple(
            np.concatenate([s[f].detach().cpu().numpy() for s in self.shards])
            for f in range(len(self.shards[0]))
        )


def shard_fields(fields: Sequence, mesh: Mesh, ctor) -> ShardedTable:
    """[P, N] arrays or tensors of a layout (``ctor`` its table type) ->
    a ShardedTable over ``mesh``; every shard field is its own copy. P must
    divide evenly."""
    p = fields[0].shape[0]
    if p % len(mesh):
        raise ValueError(f"{p} peers do not split over {len(mesh)} shards")
    b = p // len(mesh)
    shards = []
    for i, dev in enumerate(mesh):
        part = []
        for f in fields:
            t = f[i * b:(i + 1) * b]
            if not isinstance(t, torch.Tensor):  # numpy (or anything it takes)
                t = torch.from_numpy(np.array(t, dtype=np.int32))
            part.append(t.to(dev, copy=True).contiguous())
        shards.append(ctor(*part))
    return ShardedTable(shards, mesh)


def shard_table(table, mesh: Mesh) -> ShardedTable:
    """A single-device table -> a ShardedTable over ``mesh`` (copies)."""
    return shard_fields(tuple(table), mesh, type(table))
