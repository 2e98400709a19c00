"""Storage providers: abstract base + in-memory snapshots.

Behavioral twins of bullet-js src/bullet-storage.js (change detection
via deep structural diff :64-137, deep merge :146-164, save/close protocol
:171-181) and bullet-memory-storage.js (deep-copy snapshots :73-102,
optional snapshot interval :36-40, nothing persisted across sessions).

The port's own copy of ``bullet_tpu/db/storage.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ..utils.jsvalues import deep_copy


class BulletStorage:
    """Abstract provider; subclasses implement ``_load_data``/``_save_data``
    (reference subclass protocol, bullet-storage.js:31-57)."""

    def __init__(self, bullet, options: Optional[dict] = None) -> None:
        self.bullet = bullet
        self.options = {"enable_storage_log": False, **(options or {})}
        self.persisted = {"store": {}, "meta": {}, "log": []}

    # -- subclass protocol --

    def _init_storage(self) -> None:
        self._load_data()

    def _load_data(self) -> None:
        pass

    def _save_data(self) -> None:
        pass

    # -- change detection (bullet-storage.js:64-137) --

    def _has_changes(self) -> bool:
        if len(self.bullet.log) != len(self.persisted["log"]):
            return True
        for path in self.bullet.meta:
            if path not in self.persisted["meta"]:
                return True
        return self._has_store_changes(self.bullet.store, self.persisted["store"])

    def _has_store_changes(self, current: Any, persisted: Any) -> bool:
        if current is persisted:
            return False
        if type(current) is not type(persisted) or current is None or persisted is None:
            return True
        if isinstance(current, list):
            if len(current) != len(persisted):
                return True
            return any(
                self._has_store_changes(c, p) for c, p in zip(current, persisted)
            )
        if isinstance(current, dict):
            if set(current.keys()) != set(persisted.keys()):
                return True
            return any(
                self._has_store_changes(v, persisted[k]) for k, v in current.items()
            )
        return current != persisted

    def _deep_merge(self, target: dict, source: dict) -> dict:
        """Merge loaded data into the live store (bullet-storage.js:146-164)."""
        for key, value in source.items():
            if isinstance(value, dict):
                if not isinstance(target.get(key), dict):
                    target[key] = {}
                self._deep_merge(target[key], value)
            else:
                target[key] = value
        return target

    # -- public API --

    def save(self) -> None:
        self._save_data()

    def close(self) -> None:
        self._save_data()


class BulletMemoryStorage(BulletStorage):
    """In-memory snapshots, no persistence (bullet-memory-storage.js)."""

    def __init__(self, bullet, options: Optional[dict] = None) -> None:
        super().__init__(bullet, {"snapshot_interval": 0, **(options or {})})
        self._snapshot_timer: Optional[threading.Timer] = None
        self._init_storage()

    def _init_storage(self) -> None:
        super()._init_storage()
        self._save_snapshot()
        interval = self.options.get("snapshot_interval") or 0
        if interval > 0:
            self._arm_timer(interval)

    def _arm_timer(self, interval: float) -> None:
        def tick():
            self._save_snapshot()
            self._arm_timer(interval)

        self._snapshot_timer = threading.Timer(interval, tick)
        self._snapshot_timer.daemon = True
        self._snapshot_timer.start()

    def _load_data(self) -> None:
        self.persisted = {"store": {}, "meta": {}, "log": []}

    def _save_data(self) -> None:
        self._save_snapshot()

    def _save_snapshot(self) -> None:
        """Deep-copy snapshot (bullet-memory-storage.js:73-102)."""
        if not self._has_changes():
            return
        mw = self.bullet.middleware
        if mw is not None:
            mw.emit_event("storage:save:start")
        self.persisted = {
            "store": deep_copy(self.bullet.store),
            "meta": deep_copy(self.bullet.meta),
            "log": list(self.bullet.log),
        }
        if mw is not None:
            mw.emit_event("storage:save:complete")

    def close(self) -> None:
        if self._snapshot_timer is not None:
            self._snapshot_timer.cancel()
            self._snapshot_timer = None
        super().close()
