"""Durable checkpoints for the simulation engine.

The port of ``bullet_tpu.models.checkpoint``, in the same on-disk format:
the device table, the clock and (rank1) the RankIndex inverse land in
``state.npz`` (``np.savez_compressed``, keyed by the layout's field names)
and the interners' state in ``meta.json``. ``load_checkpoint`` rebuilds a
working sim (the interners are replayed in insertion order, which gives
the same ids), so a checkpoint saved by either package loads in the
other. Tables cross PCIe whole, through pageable host memory, as
``snapshot()`` does.

Only the ``npz`` backend exists here: the reference's ``orbax`` backend is
a JAX library, and a checkpoint that names it is refused.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..convert import FROM_NUMPY, TABLE_TYPES, sharded_from_numpy, table_to_numpy

FORMAT = "bullet-tpu-checkpoint"
ORBAX = "the orbax backend is JAX-only; bullet_tpu_torch reads and writes backend='npz'"


def save_checkpoint(sim, directory: str, backend: str = "npz") -> None:
    """Write ``sim`` to ``directory`` (made if missing). The field set
    follows the sim's layout (dense 7 arrays, packed 3, rank 2, rank1 1),
    assembled on the host for a sharded table.

    Queued ops are applied first (a save must not drop acknowledged puts),
    and a pending string-rank re-key runs before the arrays are read: the
    load replays the interner to its CURRENT ranks, so stale khi/klo would
    corrupt the string order for good."""
    if backend != "npz":
        raise ValueError(ORBAX if backend == "orbax" else f"unknown backend: {backend!r}")
    if any(sim._pending) or sim._pending_bulk:
        sim.step(rounds=0)
    sim._sync_device_state()
    os.makedirs(directory, exist_ok=True)
    fields = TABLE_TYPES[sim.layout]._fields
    arrays = dict(zip(fields, table_to_numpy(sim.table)))
    arrays["clock"] = sim._clock_snapshot()
    if sim.layout == "rank1":
        # rank1 stores no vid on the device: the checkpoint carries its own
        # epoch's rank -> vid inverse, through which the load decodes the
        # stored ranks onto the replayed index's ranks
        sim._sync_rank_index()
        sr, sv = sim.rank_index.inverse_arrays()
        arrays["rank_inv_ranks"] = sr.copy()
        arrays["rank_inv_vids"] = sv.copy()
    np.savez_compressed(os.path.join(directory, "state.npz"), **arrays)

    host = sim.host
    # every value but the absent and null sentinels, in one vectorized decode
    values = host.values.decode_batch(np.arange(2, len(host.values))).tolist()
    meta = {
        "format": FORMAT,
        "version": 1,
        "backend": backend,
        "num_peers": sim.num_peers,
        "capacity": sim.capacity,
        "mode": sim.mode,
        "layout": sim.layout,
        "tick": sim.tick,
        "topology": {
            "name": sim.topology.name,
            "kind": sim.topology.kind,
            "diameter": sim.topology.diameter,
            "neighbors": sim.topology.neighbors.tolist(),
        },
        "paths": [host.paths.path(i) for i in range(len(host.paths))],
        "values": values,
        "stats": sim.stats,
    }
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(directory: str, mesh_devices=None, *, device="cuda"):
    """A sim on ``device`` (over ``mesh_devices`` when given) holding the
    checkpoint's state, saved by this package or the reference's."""
    from ..parallel.topology import Topology
    from .netsim import PeerNetworkSim

    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError("not a bullet-tpu checkpoint")
    if meta.get("backend", "npz") != "npz":
        raise ValueError(ORBAX)

    t = meta["topology"]
    topology = Topology(
        name=t["name"],
        num_peers=meta["num_peers"],
        neighbors=np.asarray(t["neighbors"], dtype=np.int32),
        kind=t["kind"],
        diameter=t["diameter"],
    )
    layout = meta.get("layout", "dense")
    sim = PeerNetworkSim(
        meta["num_peers"],
        capacity=meta["capacity"],
        topology=topology,
        mode=meta["mode"],
        mesh_devices=mesh_devices,
        layout=layout,
        device=device,
    )
    # replay the interners in insertion order: the same ids and ranks
    for path in meta["paths"]:
        sim.host.intern_path(path)
    for value in meta["values"]:
        sim.host.encode_value(value)
    sim.host.needs_rekey = False

    data = np.load(os.path.join(directory, "state.npz"))
    arrays = [data[name] for name in TABLE_TYPES[layout]._fields]
    if sim.mesh is not None:
        sim.table = sharded_from_numpy(arrays, sim.mesh, layout)
    else:
        sim.table = FROM_NUMPY[layout](arrays, sim.device)
    if layout in ("rank", "rank1"):
        # gap ranks depend on the insertion HISTORY, not only on the value
        # set: the one-batch replay spreads them differently from the
        # original inserts. Rank the replayed values, then re-gather every
        # stored rank: rank through cv's vid, rank1 through the
        # checkpoint's own inverse
        sim._stage_rank_inserts()
        sim.rank_index.needs_rekey = False
        if layout == "rank":
            sim._rekey_rank()
        elif len(data["rank_inv_ranks"]):
            sim._rekey_rank1(data["rank_inv_ranks"], data["rank_inv_vids"])
    sim._clock = data["clock"].astype(np.int64)
    sim._clock_list = sim._clock.tolist()
    sim.tick = meta["tick"]
    sim.stats.update(meta.get("stats", {}))
    return sim
