"""Device mesh and sharded tables for the peer axis.

The port of ``bullet_tpu.parallel.mesh``. A mesh is a ``Mesh``: a tuple of
``torch.device``s, one per shard, that also knows which process owns each
shard. A device may repeat, so k shards can live on one card (or on the
CPU: the counterpart of XLA's forced host device count). A
``ShardedTable`` splits a table's peer rows evenly over the mesh: shard i
holds rows [i b, (i + 1) b) on mesh[i], as its own table of the layout's
type. Nothing gathers a whole sharded table onto one device: reads take
the rows they need from the owning shards, and only ``to_numpy``
(snapshots, equality checks in tests) assembles it, on the host.

A mesh built in one process owns every shard (owner 0). Once
``torch.distributed`` is initialized (``parallel/multihost.py``) a mesh
may span processes, as the reference's spans ``jax.devices()`` under its
multi-controller runtime: every process runs the same program, holds only
the shards it owns (``ShardedTable.shards`` holds None for the others),
and the exchange layer below moves rows between processes: point-to-point
sends of boundary rows and slabs, sums of counts, and the "disjoint sum"
that gives every process the same copy of rows that each owner wrote into
its own part of a zeroed buffer. Every function here that moves data of
such a mesh is a collective: every process calls it, in the same order,
with the same arguments. Under NCCL the tensors are the card's own; under
gloo, whose sends and reductions take host tensors, a card tensor goes
through a pinned host buffer (the transport's protocol, not a fallback:
NCCL is never swapped for gloo, nor the card for the CPU).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist


class Mesh(tuple):
    """The devices of a mesh's shards, in shard order, and the process
    (rank) that owns each shard. ``distributed`` meshes exchange through
    ``torch.distributed``; the others live in this process alone."""

    def __new__(cls, devices, owners: Optional[Sequence[int]] = None, rank: int = 0,
                distributed: bool = False):
        mesh = super().__new__(cls, (torch.device(d) for d in devices))
        mesh.owners = tuple(owners) if owners is not None else (rank,) * len(mesh)
        if len(mesh.owners) != len(mesh):
            raise ValueError(f"{len(mesh.owners)} owners for {len(mesh)} shards")
        mesh.rank = rank
        mesh.distributed = distributed
        mesh.local = tuple(i for i, o in enumerate(mesh.owners) if o == rank)
        if not mesh.local:
            raise ValueError(f"process {rank} owns no shard of a mesh of {len(mesh)}")
        return mesh

    def owns(self, shard: int) -> bool:
        return self.owners[shard] == self.rank

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where counts, the
        frontier's ids and replicated reads live."""
        return self[self.local[0]]


def as_mesh(mesh) -> Mesh:
    """A ``Mesh`` as it is, or a sequence of devices as a one-process mesh."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def _distributed_world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(num_devices: int, device="cuda") -> Mesh:
    """The first ``num_devices`` devices of ``device``'s type. On the CPU,
    ``num_devices`` virtual shards of the one CPU device; on CUDA it
    raises when fewer cards are visible (it never shrinks silently). Once
    ``torch.distributed`` runs a world larger than one, the first
    ``num_devices`` of the global mesh (``multihost.global_mesh``, every
    process's devices in rank order), as the reference's ``make_mesh``
    takes the first of ``jax.devices()``."""
    device = torch.device(device)
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {num_devices}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no mesh over {device.type} devices")
    if _distributed_world() > 1:
        from .multihost import global_mesh_of

        whole = global_mesh_of(device.type)
        if num_devices > len(whole):
            raise ValueError(f"a mesh of {num_devices} devices, but the processes hold "
                             f"{len(whole)}")
        return Mesh(whole[:num_devices], whole.owners[:num_devices], whole.rank, True)
    if device.type == "cpu":
        return Mesh((torch.device("cpu"),) * num_devices)
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(f"a mesh of {num_devices} CUDA devices, but {visible} are visible")
    return Mesh(torch.device("cuda", i) for i in range(num_devices))


def resolve_mesh(mesh_devices: Union[int, Sequence], device) -> Mesh:
    """A mesh from an int (``make_mesh`` over ``device``'s type), a
    ``Mesh`` (``multihost.global_mesh``'s, say), or an explicit sequence of
    devices, in which one device may repeat (a one-process mesh)."""
    if isinstance(mesh_devices, int):
        return make_mesh(mesh_devices, device)
    if isinstance(mesh_devices, Mesh):
        return mesh_devices
    if not len(mesh_devices):
        raise ValueError("a mesh needs at least one device")
    return Mesh(mesh_devices)


def pad_peers_to_mesh(num_peers: int, mesh: Mesh) -> int:
    """Smallest peer count >= num_peers divisible by the mesh size."""
    n = len(mesh)
    return ((num_peers + n - 1) // n) * n


# ------------------------------------------------------------ the transport


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor the process group's transport takes for ``t``: ``t``
    itself, or under gloo a pinned host copy of a card tensor. NCCL takes
    card tensors only."""
    if dist.get_backend() == "nccl":
        if not t.is_cuda:
            raise ValueError("NCCL moves card tensors only: a CPU mesh needs backend='gloo'")
        return t
    if t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t


def _wire_empty(shape, dtype, device: torch.device) -> torch.Tensor:
    """A receive buffer for a tensor that lands on ``device``."""
    if device.type == "cuda" and dist.get_backend() != "nccl":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    if device.type != "cuda" and dist.get_backend() == "nccl":
        raise ValueError("NCCL moves card tensors only: a CPU mesh needs backend='gloo'")
    return torch.empty(shape, dtype=dtype, device=device)


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's processes, in place (every process then
    holds the same values); ``t`` as it is on a one-process mesh."""
    if not mesh.distributed:
        return t
    flat = t.view(-1)  # a 0-d count too
    w = _wire(flat)
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    if w is not flat:
        flat.copy_(w)
    return t


def all_sum_int(mesh: Mesh, value: int) -> int:
    """A host integer summed over the mesh's processes."""
    if not mesh.distributed:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.home)
    return int(all_sum(mesh, t)[0])


def disjoint_sum(mesh: Mesh, blocks: Dict[int, torch.Tensor], shape, dtype=torch.int32
                 ) -> torch.Tensor:
    """[S, *shape] on mesh.home, the same on every process: row i is
    ``blocks[i]``, which shard i's owner gives (every process gives its
    own shards'). The rows are written into a zeroed buffer and summed
    over the processes: rows are disjoint, so the sum is exact."""
    out = torch.zeros((len(mesh), *shape), dtype=dtype, device=mesh.home)
    for i, b in blocks.items():
        out[i] = b.to(mesh.home)
    return all_sum(mesh, out)


def _copy_rows(src: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """Copies of [r, N] row blocks on ``device``."""
    return [torch.empty(f.shape, dtype=f.dtype, device=device).copy_(f) for f in src]


# a transfer: (source shard, destination shard, rows r, take) where take()
# gives the source shard's nf [r, N] blocks on its device
Transfer = Tuple[int, int, int, Callable[[], Sequence[torch.Tensor]]]


def transfer(mesh: Mesh, jobs: Sequence[Transfer], nf: int, n: int, copy: bool = True
             ) -> Dict[int, List[torch.Tensor]]:
    """Row blocks moved between shards (the ppermute and all_gather of the
    reference's shard_map): every process lists the same ``jobs`` in the
    same order; returns, for every job whose destination this process
    owns, the nf [r, N] blocks on the destination's device. Between shards
    of one process the blocks are copies (or, with ``copy=False``, the
    source's own tensors where the devices match: the caller copies them);
    across processes the source's owner sends them as one [nf, r, N]
    message, all sends and receives of the call posted together
    (``batch_isend_irecv``, tagged by job)."""
    out: Dict[int, List[torch.Tensor]] = {}
    ops, inbox = [], []
    for k, (src, dst, r, take) in enumerate(jobs):
        here, there = mesh.owns(src), mesh.owns(dst)
        if here and there:
            blocks = take()
            out[k] = (_copy_rows(blocks, mesh[dst]) if copy
                      else [b.to(mesh[dst]) for b in blocks])
        elif here:
            msg = _wire(torch.stack([b.contiguous() for b in take()]))
            ops.append(dist.P2POp(dist.isend, msg, mesh.owners[dst], tag=k))
        elif there:
            buf = _wire_empty((nf, r, n), torch.int32, mesh[dst])
            ops.append(dist.P2POp(dist.irecv, buf, mesh.owners[src], tag=k))
            inbox.append((k, buf, mesh[dst]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for k, buf, dev in inbox:
        out[k] = list(buf.to(dev).unbind(0))
    return out


def broadcast_from(mesh: Mesh, shard: int, t: Optional[torch.Tensor], shape,
                   dtype=torch.int32, device=None) -> torch.Tensor:
    """``t`` of shard ``shard``'s owner (None elsewhere) on every process,
    on ``device`` (default mesh.home)."""
    device = device or mesh.home
    if not mesh.distributed:
        return t.to(device)
    buf = (_wire(t.to(device).contiguous()) if mesh.owns(shard)
           else _wire_empty(shape, dtype, device))
    dist.broadcast(buf, src=mesh.owners[shard])
    return buf.to(device)


class ShardedTable:
    """A table split by peer rows over a mesh: ``shards[i]`` is a table of
    the layout's type holding rows [i b, (i + 1) b) on ``mesh[i]``, or None
    where another process owns shard i."""

    def __init__(self, shards: Sequence, mesh) -> None:
        mesh = as_mesh(mesh)
        if len(shards) != len(mesh):
            raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
        self.shards: List = list(shards)
        self.mesh: Mesh = mesh
        if any(self.shards[i] is None for i in mesh.local):
            raise ValueError("a shard of this process is missing")

    @property
    def first(self):
        """This process's first shard."""
        return self.shards[self.mesh.local[0]]

    @property
    def rows(self) -> int:
        """Peer rows per shard."""
        return self.first[0].shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        """(P, N) of the whole table."""
        return self.rows * len(self.shards), self.first[0].shape[1]

    def local(self) -> List[Tuple[int, object]]:
        """(index, shard) of this process's shards."""
        return [(i, self.shards[i]) for i in self.mesh.local]

    def map(self, fn: Callable) -> "ShardedTable":
        """A sharded table of ``fn(shard)`` for every shard of this process."""
        return ShardedTable([None if s is None else fn(s) for s in self.shards], self.mesh)

    def owner(self, peers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(shard index, local row) of global peer rows."""
        return np.divmod(np.asarray(peers, dtype=np.int64), self.rows)

    def take_rows(self, peers: np.ndarray, device, fields=None) -> List[torch.Tensor]:
        """The global rows ``peers`` (any order, repeats allowed) of every
        field (or of the field indices ``fields``), as [len(peers), N]
        tensors on ``device``, copied from the owning shards. On a mesh of
        processes every process gets them all (a collective)."""
        peers = np.asarray(peers, dtype=np.int64)
        which = list(range(len(self.first))) if fields is None else list(fields)
        shard, local = self.owner(peers)
        buf = torch.zeros((len(which), len(peers), self.shape[1]), dtype=torch.int32,
                          device=self.mesh.home if self.mesh.distributed else device)
        for i, s in self.local():
            sel = np.flatnonzero(shard == i)
            if len(sel):
                src = torch.from_numpy(local[sel]).to(self.mesh[i])
                dst = torch.from_numpy(sel).to(buf.device)
                for o, f in zip(buf, which):
                    o[dst] = s[f].index_select(0, src).to(buf.device)
        return [f.to(device) for f in all_sum(self.mesh, buf)]

    def put_rows(self, peers: np.ndarray, rows: Sequence[torch.Tensor], fields=None) -> None:
        """Write [len(peers), N] ``rows`` (of every field, or of the field
        indices ``fields``) into the global rows ``peers``, in place: each
        process writes its own shards' rows (every process holds the same
        ``rows``)."""
        peers = np.asarray(peers, dtype=np.int64)
        which = range(len(self.first)) if fields is None else fields
        shard, local = self.owner(peers)
        for i, s in self.local():
            sel = np.flatnonzero(shard == i)
            if not len(sel):
                continue
            dev = self.mesh[i]
            dst = torch.from_numpy(local[sel]).to(dev)
            for r, f in zip(rows, which):
                s[f][dst] = r[torch.from_numpy(sel).to(r.device)].to(dev)

    def row_table(self, peer: int):
        """(table, row): a table holding ``peer``'s row and its index there —
        the owning shard on its device, or on a mesh of processes a one-row
        table on mesh.home that the owner broadcast (a collective)."""
        shard, local = (int(x) for x in self.owner(peer))
        if not self.mesh.distributed:
            return self.shards[shard], local
        s = self.shards[shard]
        nf, n = len(self.first), self.shape[1]
        mine = torch.stack([f[local] for f in s]) if s is not None else None
        row = broadcast_from(self.mesh, shard, mine, (nf, n))
        return type(self.first)(*(f[None] for f in row)), 0

    def gather(self, peers: np.ndarray, slots: np.ndarray, fields: Sequence[int]) -> List[np.ndarray]:
        """The entries at the K (peer, slot) pairs of the field indices
        ``fields``, as numpy arrays: one device gather per shard and field
        into one buffer on mesh.home (on a mesh of processes, summed over
        them: the entries are disjoint), one copy to the host."""
        peers = np.asarray(peers, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        shard, local = self.owner(peers)
        buf = torch.zeros((len(fields), len(peers)), dtype=torch.int32, device=self.mesh.home)
        for i, s in self.local():
            sel = np.flatnonzero(shard == i)
            if len(sel):
                idx = tuple(torch.from_numpy(a[sel]).to(self.mesh[i]) for a in (local, slots))
                dst = torch.from_numpy(sel).to(buf.device)
                for o, f in zip(buf, fields):
                    o[dst] = s[f][idx].to(buf.device)
        return list(all_sum(self.mesh, buf).cpu().numpy())

    def to_numpy(self) -> Tuple[np.ndarray, ...]:
        """Every field of the whole table as int32 [P, N] host arrays, shard
        by shard through mesh.home. On a mesh of processes every process
        gets the whole table: each shard's owner broadcasts it, field by
        field (a collective that moves the whole table to every process's
        host, through a shard-sized buffer on its home device)."""
        b, n = self.rows, self.shape[1]
        return tuple(
            np.concatenate([
                broadcast_from(self.mesh, i, None if s is None else s[f].detach(),
                               (b, n)).cpu().numpy()
                for i, s in enumerate(self.shards)
            ])
            for f in range(len(self.first))
        )


def shard_fields(fields: Sequence, mesh, ctor) -> ShardedTable:
    """[P, N] arrays or tensors of a layout (``ctor`` its table type) ->
    a ShardedTable over ``mesh`` holding this process's shards; every shard
    field is its own copy. P must divide evenly."""
    mesh = as_mesh(mesh)
    p = fields[0].shape[0]
    if p % len(mesh):
        raise ValueError(f"{p} peers do not split over {len(mesh)} shards")
    b = p // len(mesh)
    shards: List = [None] * len(mesh)
    for i in mesh.local:
        part = []
        for f in fields:
            t = f[i * b:(i + 1) * b]
            if not isinstance(t, torch.Tensor):  # numpy (or anything it takes)
                t = torch.from_numpy(np.array(t, dtype=np.int32))
            part.append(t.to(mesh[i], copy=True).contiguous())
        shards[i] = ctor(*part)
    return ShardedTable(shards, mesh)


def shard_table(table, mesh) -> ShardedTable:
    """A single-device table -> a ShardedTable over ``mesh`` (copies)."""
    return shard_fields(tuple(table), mesh, type(table))
