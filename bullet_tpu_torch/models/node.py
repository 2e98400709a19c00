"""Fluent per-peer cursor over the simulation engine.

Mirrors the bullet-js ``BulletNode`` chainable API, so code written against
the host db layer ports to the engine by swapping ``bullet.get(path)`` for
``sim.peer(p).get(path)``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .table import MISSING


class SimPeer:
    """A peer-scoped view of the sim: ``sim.peer(3).get("users/a").put(...)``."""

    def __init__(self, sim, peer: int) -> None:
        self.sim = sim
        self.index = peer

    def get(self, path: str) -> "SimNode":
        return SimNode(self.sim, self.index, path)

    def value(self) -> Any:
        return self.sim.get(self.index)

    # the peer-scoped query facade (the bullet-js Bullet query facades)
    def equals(self, base: str, field, value: Any = MISSING):
        args = (field,) if value is MISSING else (field, value)
        return self.sim.equals(self.index, base, *args)

    def range(self, base: str, field, lo=MISSING, hi=MISSING):
        args = (field, lo) if hi is MISSING else (field, lo, hi)
        return self.sim.range(self.index, base, *args)

    def filter(self, base: str, fn: Callable):
        return self.sim.filter(self.index, base, fn)

    def find(self, base: str, fn: Callable):
        return self.sim.find(self.index, base, fn)

    def map(self, base: str, fn: Callable):
        return self.sim.map(self.index, base, fn)

    def count(self, base: str, field, value: Any = MISSING) -> int:
        args = (field,) if value is MISSING else (field, value)
        return self.sim.count(self.index, base, *args)


class SimNode:
    """Chainable cursor (value/put/on/get/off/remove)."""

    def __init__(self, sim, peer: int, path: str) -> None:
        self.sim = sim
        self.peer = peer
        self.path = path

    def value(self) -> Any:
        return self.sim.get(self.peer, self.path)

    def put(self, data: Any) -> "SimNode":
        self.sim.put(self.peer, self.path, data)
        return self

    def on(self, callback: Callable[[Any], None]) -> "SimNode":
        self.sim.on(self.peer, self.path, callback)
        return self

    def off(self, callback: Optional[Callable] = None) -> "SimNode":
        self.sim.off(self.peer, self.path, callback)
        return self

    def get(self, child_path: str) -> "SimNode":
        full = f"{self.path}/{child_path}" if self.path else child_path
        return SimNode(self.sim, self.peer, full)

    def remove(self) -> "SimNode":
        self.sim.remove(self.peer, self.path)
        return self

    delete = remove
