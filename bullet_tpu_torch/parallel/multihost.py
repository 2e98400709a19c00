"""Several processes, one mesh: the port of ``bullet_tpu.parallel.multihost``.

One process per card (or, under gloo, several per card, or CPU processes),
each holding the shards it owns; ``torch.distributed`` joins them, and the
mesh's exchanges (``parallel/mesh.py``) become sends, receives and sums
between processes wherever two shards live in different ones. Every
process runs the same program (SPMD) and calls the same sim methods in the
same order with the same arguments: a method that reads or writes rows or
counts across shards is a collective, as it is under the reference's
multi-controller runtime.

Typical launch (the same script in every process):

    from bullet_tpu_torch.parallel.multihost import initialize_multihost, global_mesh
    initialize_multihost("host0:29500", num_processes=4, process_id=RANK)
    torch.cuda.set_device(LOCAL_RANK)
    mesh = global_mesh()                    # every process's cards, in rank order
    sim = PeerNetworkSim(4096, capacity=1 << 20, topology="ring", layout="rank1",
                         mesh_devices=mesh, use_shard_map=True)

NCCL (the default) moves card tensors between processes with one card
each: it refuses two processes on one card. gloo (``backend="gloo"``)
takes CPU meshes and several processes on one card, staging card tensors
through pinned host buffers.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

# how long a collective waits for a process that died or took another
# branch before it fails (gloo's own default is 30 minutes)
DEFAULT_TIMEOUT_S = 120.0

# the global mesh of the last ``global_mesh`` call, which ``make_mesh``
# takes its first devices from
_GLOBAL: Optional[Mesh] = None


def initialize_multihost(
    coordinator_address: str,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group at ``coordinator_address`` ("host:port"; rank
    0 listens there), idempotent per process. ``num_processes`` and
    ``process_id`` default to the WORLD_SIZE and RANK environment
    variables. ``backend`` is "nccl" (the default) or "gloo"; every
    collective fails after ``timeout_s`` seconds without its peers."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(
        backend or "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _visible(kind: str = "cuda") -> list:
    """This process's devices by default: the visible cards, or one CPU."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_mesh(local_devices: Optional[Sequence] = None) -> Mesh:
    """The mesh over every process's devices, the same on every process:
    each process's ``local_devices`` (default: its visible cards; a device
    may repeat, ``["cuda:0"] * 2`` or ``["cpu"] * 2``), gathered in rank
    order, each shard owned by the process that gave it. A collective;
    without ``torch.distributed`` a one-process mesh of the local
    devices."""
    global _GLOBAL
    local = [torch.device(d) for d in (local_devices if local_devices is not None
                                       else _visible())]
    if not local:
        raise ValueError("a process of the mesh needs at least one device")
    if not dist.is_initialized():
        return Mesh(local)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in local])
    devices = [d for part in gathered for d in part]
    owners = [r for r, part in enumerate(gathered) for _ in part]
    _GLOBAL = Mesh(devices, owners, dist.get_rank(), distributed=True)
    return _GLOBAL


def global_mesh_of(kind: str) -> Mesh:
    """The last global mesh if its devices are of ``kind``, else a new one
    over this process's default devices of that kind (a collective)."""
    if _GLOBAL is not None and _GLOBAL.home.type == kind:
        return _GLOBAL
    return global_mesh(_visible(kind))


def is_multihost() -> bool:
    """Whether ``torch.distributed`` runs a world of more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_info() -> dict:
    """The reference's four keys: this process's rank, the world size, and
    the devices of this process and of all (from the last global mesh; the
    first call without one gathers it, a collective)."""
    if not dist.is_initialized():
        local = len(_visible()) if _GLOBAL is None else len(_GLOBAL.local)
        return {"process_index": 0, "process_count": 1, "local_devices": local,
                "global_devices": local}
    mesh = _GLOBAL if _GLOBAL is not None else global_mesh()
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": len(mesh.local),
        "global_devices": len(mesh),
    }
