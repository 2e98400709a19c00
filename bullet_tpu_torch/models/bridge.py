"""Bridge between the db layer and the engine.

Moves data between a live ``Bullet`` (one process, real networking) and a
``PeerNetworkSim`` (thousands of simulated peers on a device): seed a sim
from a database's state, write a converged replica back into a database,
or mirror every write a live database accepts into a sim replica that
request handlers query through a read-only ``ReplicaView``.

The port of ``bullet_tpu.models.bridge``: the same functions and
contracts; the db objects are this package's (``bullet_tpu_torch.db``),
and a sim built here lives on ``device`` (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from .table import MISSING, flatten_value


def load_bullet_into_sim(bullet, sim, peer: int = 0) -> int:
    """Queue every leaf of a Bullet's store as puts at ``peer``, in ONE
    ``put_bulk`` call (the sync wire format's leaf decomposition; paths
    are unique per traversal, so the batch's lattice reduction picks no
    winners and the converged state is that of per-leaf puts). Returns
    the number of leaves queued; ``step``/``run_until_converged`` applies
    them."""
    paths: list = []
    values: list = []

    def traverse(obj, prefix: str):
        if not isinstance(obj, dict):
            paths.append(prefix)
            values.append(obj)
            return
        for key, value in obj.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                traverse(value, path)
            else:
                paths.append(path)
                values.append(value)

    traverse(bullet.store, "")
    if paths:
        sim.put_bulk(peer, paths, values)
    return len(paths)


def dump_sim_into_bullet(sim, bullet, peer: int = 0, broadcast: bool = False) -> int:
    """Write a peer's replica into a Bullet through its normal write path
    (CRT, validation, middleware and indexes all apply). Returns the
    number of leaves written."""
    count = 0
    values = sim._decode_slots(peer, list(range(len(sim.host.paths))))
    for slot, value in values.items():
        bullet.set_data(sim.host.paths.path(slot), value, broadcast=broadcast)
        count += 1
    return count


def sim_from_bullet(
    bullet,
    num_peers: int,
    topology="ring",
    mode: str = "reference",
    mesh_devices=None,
    *,
    device="cuda",
):
    """A dense sim on ``device``, converged, seeded with a Bullet's state
    (capacity: 2 slots a leaf, at least 128)."""
    from .netsim import PeerNetworkSim

    capacity = max(128, 2 * _count_leaves(bullet.store))
    sim = PeerNetworkSim(
        num_peers,
        capacity=capacity,
        topology=topology,
        mode=mode,
        mesh_devices=mesh_devices,
        device=device,
    )
    load_bullet_into_sim(bullet, sim, peer=0)
    sim.run_until_converged()
    return sim


def _count_leaves(obj) -> int:
    if not isinstance(obj, dict):
        return 1
    return sum(_count_leaves(v) for v in obj.values()) or 0


class ReplicaView:
    """Read-only queries on ONE peer's replica: the sim's query methods
    without the peer argument and without any write method, so it can be
    handed to request handlers.

    ``refresh`` sets the staleness of each query:
    - ``"apply"`` (default): apply the queued writes first (no gossip; the
      bound peer's row is current once its ops land, which is the live
      mirror's case: every mirror write targets this peer);
    - ``"converge"``: gossip to the fixed point first (writes that reach
      the sim at other peers);
    - ``None``: serve the last applied state.

    The lock (the bridge's, from ``attach_live_bridge``) is held across
    the WHOLE query, refresh included: reads change sim state (capacity
    growth, re-keys; a rank1 decode must use the inverse of the epoch of
    the ranks it reads)."""

    def __init__(self, sim, peer: int = 0, refresh: Optional[str] = "apply",
                 lock=None, pump=None) -> None:
        if refresh not in ("apply", "converge", None):
            raise ValueError(f"unknown refresh policy: {refresh!r}")
        self._sim = sim
        self._peer = peer
        self._refresh = refresh
        self._lock = lock if lock is not None else threading.Lock()
        self._pump = pump

    def _refresh_locked(self):
        if self._pump is not None and self._refresh is not None:
            self._pump()  # the bridges' staged writes, as one put_bulk each
        if self._refresh == "apply":
            self._sim.step(rounds=0)
        elif self._refresh == "converge":
            self._sim.run_until_converged()

    def get(self, path: str = ""):
        with self._lock:
            self._refresh_locked()
            return self._sim.get(self._peer, path)

    def equals(self, base: str, field, value=MISSING):
        with self._lock:
            self._refresh_locked()
            return self._sim.equals(self._peer, base, field, value)

    def range(self, base: str, field, lo=MISSING, hi=MISSING):
        with self._lock:
            self._refresh_locked()
            return self._sim.range(self._peer, base, field, lo, hi)

    def count(self, base: str, field, value=MISSING) -> int:
        with self._lock:
            self._refresh_locked()
            return self._sim.count(self._peer, base, field, value)

    def filter(self, base: str, fn):
        with self._lock:
            self._refresh_locked()
            return self._sim.filter(self._peer, base, fn)

    def find(self, base: str, fn):
        with self._lock:
            self._refresh_locked()
            return self._sim.find(self._peer, base, fn)

    def map(self, base: str, fn):
        with self._lock:
            self._refresh_locked()
            return self._sim.map(self._peer, base, fn)


def _leaves(stage: deque):
    """Pop the (path, value) writes staged so far and decompose them into
    leaf paths and values. Only as many as the stage held at the start:
    what races in is the next drain's work, so a sustained flood cannot
    pin a drain."""
    paths: list = []
    values: list = []
    for _ in range(len(stage)):
        try:
            path, value = stage.popleft()
        except IndexError:  # a racing pump drained it first
            break
        for leaf_path, leaf_value in flatten_value(path, value):
            paths.append(leaf_path)
            values.append(leaf_value)
    return paths, values


def attach_live_bridge(bullet, sim, peer: int = 0):
    """Mirror every write a live Bullet ACCEPTS (local puts and writes
    applied from the network, flood or sync) into the sim as leaf puts at
    ``peer``. The hook rides ``_apply_update``, the one point every
    resolved write passes through, so the mirror follows the db's post-CRT
    state: a wire-connected peer becomes a replica on the device.

    Dict values decompose into leaf puts as the sync wire format does: the
    mirror is leaf-merge, not subtree-replace. The mirror applies the db's
    resolved values under the engine's reference-mode order (value max);
    a clock-dominant update that lowers a value (possible after an
    anti-entropy clock exchange) replaces in the db while the mirror keeps
    the larger value. Concurrent writes resolve by value on both sides.

    The forwarder takes NO lock: it appends the accepted (path, value) to
    this bridge's staging deque. Queries through ``view()``, ``pump()``
    and ``flush()`` drain the stages under the sim's bridge lock, one
    ``put_bulk`` per bridge, so a wire thread never convoys a query and
    ``refresh="apply"`` still reads every write accepted before the query
    began. Code that reads ``sim`` directly should ``pump()`` first.

    The lock and the stage registry live on the SIM (``_bridge_lock``,
    ``_bridge_stages``): any handle's pump, flush or view query drains
    EVERY attached bridge's stage. Bridges stack (each wraps the current
    ``_apply_update``); detach in reverse attach order, since a detach
    restores the hook it captured.

    Returns a handle with ``detach()`` (restores the hook and folds this
    bridge's remaining stage into the sim's queue), ``pump()``,
    ``backlog()``, ``flush()`` (pump, then converge) and
    ``view(refresh="apply")``."""
    orig = bullet._apply_update
    lock = sim._bridge_lock
    staged: deque = deque()
    stage_entry = (staged, peer)
    sim._bridge_stages.append(stage_entry)

    def forward(path, value, vector_clock, from_network):
        orig(path, value, vector_clock, from_network)
        staged.append((path, value))

    bullet._apply_update = forward

    def pump_locked() -> int:
        """Drain every attached bridge's stage into the sim's queue; the
        caller holds ``sim._bridge_lock``."""
        total = 0
        for stage, stage_peer in list(sim._bridge_stages):
            paths, values = _leaves(stage)
            if paths:
                sim.put_bulk(stage_peer, paths, values)
                total += len(paths)
        return total

    class _Handle:
        def detach(self) -> None:
            bullet._apply_update = orig
            with lock:
                # staged writes are accepted db state: fold them in
                paths, values = _leaves(staged)
                if paths:
                    sim.put_bulk(peer, paths, values)
                try:
                    sim._bridge_stages.remove(stage_entry)
                except ValueError:
                    pass  # already detached

        def pump(self) -> int:
            """Move every attached bridge's staged writes into the sim's
            queue (no gossip). Returns the leaves moved."""
            with lock:
                return pump_locked()

        def backlog(self) -> int:
            """This bridge's staged writes not yet pumped."""
            return len(staged)

        def flush(self) -> int:
            """Pump, then converge; returns the rounds."""
            with lock:
                pump_locked()
                return sim.run_until_converged()

        def view(self, refresh: Optional[str] = "apply") -> ReplicaView:
            return ReplicaView(sim, peer, refresh=refresh, lock=lock, pump=pump_locked)

    return _Handle()
