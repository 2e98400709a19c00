"""Bullet core: path-addressed graph store, write path, subscriptions.

Host-side drop-in with the reference's API surface and observable behavior
(bullet-js src/bullet.js). Layering is an explicit pipeline rather than
the reference's monkey-patch onion, but hook ordering matches the reference
construction order (bullet.js:37-64): middleware wraps get/set, query index
maintenance runs after the write, CRT resolves every write.

Deliberate deviations (documented in DESIGN.md):
* validation runs on the real write path (the reference's hook is dead code —
  SURVEY quirk Q1); pass ``validate_on_write=False`` for reference behavior.
* networking uses a TCP/NDJSON transport instead of WebSockets.

The port's own copy of ``bullet_tpu/db/core.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.jsvalues import deep_copy, js_falsy
from ..utils.paths import ancestors, normalize, split_path
from .crt import BulletCRT

DEFAULT_OPTIONS = {
    "peers": (),
    "server": True,
    "storage": True,
    "storage_type": "file",
    "storage_path": "./.bullet",
    "save_interval": 5.0,
    "encrypt": False,
    "encryption_key": None,
    "enable_indexing": True,
    "enable_validation": True,
    "enable_middleware": True,
    "enable_serializer": True,
    "enable_storage_log": False,
    "disable_network": False,
    "disable_crt": False,
    "validate_on_write": True,  # fix of reference quirk Q1
    "autovivify": True,  # reference quirk Q3 (reads create empty objects)
    # "js" = reference comparator (bullet-crt.js:11-15; incomparable pairs
    # resolve by arrival order — a documented divergence residual), "total" =
    # antisymmetric total order (identical-clock conflicts always converge),
    # or any callable (incoming, existing) -> -1|0|1
    "compare": "js",
    "host": "0.0.0.0",
    "port": 8765,
}

_CAMEL = {
    "storageType": "storage_type",
    "storagePath": "storage_path",
    "saveInterval": "save_interval",
    "encryptionKey": "encryption_key",
    "enableIndexing": "enable_indexing",
    "enableValidation": "enable_validation",
    "enableMiddleware": "enable_middleware",
    "enableSerializer": "enable_serializer",
    "enableStorageLog": "enable_storage_log",
    "disableNetwork": "disable_network",
    "disableCRT": "disable_crt",
    "validateOnWrite": "validate_on_write",
}


def _normalize_options(options: Optional[dict]) -> dict:
    opts = dict(DEFAULT_OPTIONS)
    for key, value in (options or {}).items():
        opts[_CAMEL.get(key, key)] = value
    # save_interval accepts ms (reference units) or seconds
    si = opts["save_interval"]
    if isinstance(si, (int, float)) and si > 100:
        opts["save_interval"] = si / 1000.0
    return opts


def generate_peer_id(rng: Optional[random.Random] = None) -> str:
    """UUIDv4-shaped peer id (bullet.js:273-282)."""
    rng = rng or random
    out = []
    for c in "xxxxxxxx-xxxx-4xxx-yxxx-xxxxxxxxxxxx":
        if c == "x":
            out.append(format(rng.randrange(16), "x"))
        elif c == "y":
            out.append(format(rng.randrange(4) | 8, "x"))
        else:
            out.append(c)
    return "".join(out)


class MetaMap(dict):
    """Path-keyed meta store with a maintained ancestor index, so
    "which meta keys live strictly under path p" is O(1) to ask and
    O(depth) to maintain — _apply_update drops superseded descendant
    metas on every write (an applied write at p replaces p's WHOLE
    subtree in the store, so descendant metas' clocks/stamps describe
    values that no longer exist; left behind, they ship stale clocks
    through _leaf_meta and can freeze anti-entropy into a permanent
    split — see sync._collect_full_sync_data)."""

    def __init__(self, *args, **kw) -> None:
        super().__init__()
        self._desc: Dict[str, set] = {}
        if args or kw:
            self.update(*args, **kw)

    def __setitem__(self, key: str, value: dict) -> None:
        if key not in self:
            parts = key.split("/")
            for i in range(1, len(parts)):
                self._desc.setdefault("/".join(parts[:i]), set()).add(key)
        super().__setitem__(key, value)

    def __delitem__(self, key: str) -> None:
        super().__delitem__(key)
        parts = key.split("/")
        for i in range(1, len(parts)):
            anc = "/".join(parts[:i])
            kids = self._desc.get(anc)
            if kids is not None:
                kids.discard(key)
                if not kids:
                    del self._desc[anc]

    def pop(self, key, *default):
        if key in self:
            val = self[key]
            del self[key]
            return val
        if default:
            return default[0]
        raise KeyError(key)

    def update(self, *args, **kw) -> None:  # route through __setitem__
        for src in args:
            items = src.items() if hasattr(src, "items") else src
            for k, v in items:
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    def clear(self) -> None:
        super().clear()
        self._desc.clear()

    def descendants(self, path: str) -> tuple:
        """Meta keys STRICTLY under ``path`` (snapshot tuple — callers
        delete while iterating)."""
        return tuple(self._desc.get(path, ()))


class Bullet:
    """A path-addressed, replicated JSON graph (reference: bullet.js:10-676)."""

    def __init__(self, options: Optional[dict] = None) -> None:
        self.options = _normalize_options(options)
        self.store: Dict[str, Any] = {}
        self.listeners: Dict[str, List[Callable[[Any], None]]] = {}
        self.log: List[dict] = []
        self.meta: MetaMap = MetaMap()
        self.id = self.options.get("peer_id") or generate_peer_id()
        self._save_timer: Optional[threading.Timer] = None
        self._closed = False
        self._lock = threading.RLock()

        self.middleware = None
        self.storage = None
        self.query = None
        self.validation = None
        self.serializer = None
        self.network = None
        self.crt: BulletCRT

        # construction order mirrors bullet.js:37-64
        if self.options["enable_middleware"]:
            from .middleware import BulletMiddleware

            self.middleware = BulletMiddleware(self)
        if self.options["storage"]:
            self._init_storage()
        if self.options["enable_indexing"]:
            from .query import BulletQuery

            self.query = BulletQuery(self)
        if self.options["enable_validation"]:
            from .validation import BulletValidation

            self.validation = BulletValidation(self)
        if self.options["enable_serializer"]:
            from .serializer import BulletSerializer

            self.serializer = BulletSerializer(self)
        # CRT before networking: inbound messages can hit set_data the moment
        # reader threads exist (disable_crt accepted for option parity only —
        # conflict resolution is integral here)
        self.crt = BulletCRT(self)
        cmp_opt = self.options["compare"]
        if cmp_opt == "total":
            from ..utils.jsvalues import total_compare

            self.crt.set_compare(total_compare)
        elif callable(cmp_opt):
            self.crt.set_compare(cmp_opt)
        elif cmp_opt != "js":
            raise ValueError(f"unknown compare option: {cmp_opt!r}")
        # restarted instances with a pinned peer_id must resume their clocks
        # from persisted meta, or the first write per path is dropped as
        # historical (random-id boots, like the reference, start concurrent)
        for meta_path, meta in self.meta.items():
            clock = meta.get("vectorClock")
            if isinstance(clock, dict):
                self.crt.vector_clocks[meta_path] = clock
        if not self.options["disable_network"]:
            from .network import BulletNetwork

            self.network = BulletNetwork(self, self.options)

    def _init_storage(self) -> None:
        """Pick the storage provider (bullet.js:71-99)."""
        storage_options = {
            "path": self.options["storage_path"],
            "save_interval": self.options["save_interval"],
            "encrypt": self.options["encrypt"],
            "encryption_key": self.options["encryption_key"],
            "enable_storage_log": self.options["enable_storage_log"],
        }
        stype = self.options["storage_type"]
        if stype == "file":
            from .file_storage import BulletFileStorage

            self.storage = BulletFileStorage(self, storage_options)
        elif stype == "memory":
            from .storage import BulletMemoryStorage

            self.storage = BulletMemoryStorage(self, storage_options)
        elif callable(stype):
            self.storage = stype(self, storage_options)
        else:
            from .storage import BulletMemoryStorage

            self.storage = BulletMemoryStorage(self, storage_options)

    # ------------------------------------------------------------------ reads

    def get(self, path: str) -> "BulletNode":
        return BulletNode(self, path)

    def _get_data_raw(self, path: str) -> Any:
        """Walk the store, reproducing the reference walk exactly
        (quirk Q3, bullet.js:115-129): a missing OR JS-falsy segment value is
        replaced with ``{}`` (reads are writes!), and traversing through a
        scalar raises TypeError (the reference's strict-mode behavior).
        ``autovivify=False`` switches to a non-destructive walk."""
        if not path:
            return self.store
        current = self.store
        parts = split_path(path)
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            if isinstance(current, dict):
                value = current.get(part)
                if js_falsy(value):
                    if self.options["autovivify"]:
                        current[part] = {}
                    else:
                        # non-destructive mode: a falsy value only answers
                        # the final segment; deeper paths don't exist
                        return value if last else None
                current = current[part] if part in current else None
                if current is None and not self.options["autovivify"]:
                    return None
            elif isinstance(current, list):
                if part.isdigit() and int(part) < len(current):
                    current = current[int(part)]
                else:
                    # JS arrays are objects: a vivified non-index property is
                    # unreachable from a Python list, so return {} unpersisted
                    return {} if self.options["autovivify"] else None
            else:
                if self.options["autovivify"]:
                    raise TypeError(
                        f"Cannot create property '{part}' on {type(current).__name__}"
                    )
                return None
        return current

    def _get_data(self, path: str) -> Any:
        """Middleware-wrapped read (bullet-middleware.js:27-68): get hooks may
        rewrite the path (errors are caught and reported), afterGet hooks may
        rewrite the data, then a "read" event fires."""
        mw = self.middleware
        if mw is None:
            return self._get_data_raw(path)
        if (
            not mw.middleware["get"]
            and not mw.middleware["afterGet"]
            and not mw.event_listeners.get("read")
            and not mw.event_listeners.get("all")
        ):
            # nothing can observe the pipeline: skip the hook loops and
            # the listener-less "read" event (hot — every read and every
            # CRT handle_update pays this)
            return self._get_data_raw(path)
        return self.middleware.wrapped_get(path, self._get_data_raw)

    # ----------------------------------------------------------------- writes

    def set_data(
        self,
        path: str,
        raw_data: Any,
        broadcast: bool = True,
        incoming_clock=None,
    ):
        """The write path (bullet.js:139-155 plus the middleware/query wrappers;
        call order documented in SURVEY §3.2).

        ``incoming_clock`` carries a replicated entry's vector clock for
        values that can't embed ``__vectorClock`` (scalars, deletes,
        arrays) — the sync apply path uses it so every entry kind
        resolves through the CRT instead of re-applying as a local write
        (see BulletCRT.handle_update)."""
        path = normalize(path)
        with self._lock:
            if self.middleware is not None:
                cont, path, raw_data = self.middleware.run_put_hooks(path, raw_data)
                if not cont:
                    return False
            data, from_network = self._strip_network_flag(raw_data)
            if incoming_clock is not None:
                from_network = True  # an explicit clock IS a replica's write
            if self.validation is not None and self.options["validate_on_write"]:
                # validate the clean payload: wire markers (__vectorClock;
                # __fromNetwork already stripped) are transport framing, not
                # user data — otherwise strict schemas would reject every
                # replicated write and peers would diverge
                check_data = (
                    {k: v for k, v in data.items() if k != "__vectorClock"}
                    if isinstance(data, dict)
                    else data
                )
                if not self.validation.check_write(path, check_data):
                    return False
            # old_data is only observable through afterPut hooks and
            # "write"/"all" event listeners — skip the deep copy (hot:
            # every put pays it, and subtrees can be large) when nothing
            # can see it
            mw = self.middleware
            old_data = (
                deep_copy(self._get_data_raw(path))
                if mw is not None and (
                    mw.middleware["afterPut"]
                    or mw.event_listeners.get("write")
                    or mw.event_listeners.get("all")
                )
                else None
            )
            result = self.crt.handle_update(
                path, data, from_network, incoming_clock=incoming_clock
            )

            if result["doUpdate"]:
                self._apply_update(
                    path, result["value"], result["vectorClock"], from_network
                )
                if broadcast and self.network is not None:
                    self.network.broadcast(
                        path,
                        result["broadcastData"],
                        vector_clock=result["vectorClock"],
                    )
            elif incoming_clock is not None and result["value"] != data:
                # a replicated entry LOST to dominant local state: the
                # sender is stale, and its `since` watermark may already
                # postdate this path's lastModified — in which case our
                # winning value would never be re-offered and the pair
                # stays diverged forever. Touch lastModified so the next
                # anti-entropy pass re-collects the path for every peer.
                # (The concurrent-loss case needs no touch: doUpdate is
                # True there and _apply_update restamps.)
                meta = self.meta.get(path)
                if meta:
                    self.meta[path] = {
                        **meta, "lastModified": int(time.time() * 1000)
                    }

            if self.middleware is not None:
                self.middleware.run_after_put_hooks(path, data, old_data)
            if self.query is not None:
                self.query._update_indices(path, data)
            return result["value"]

    # camelCase alias mirroring the reference API
    setData = set_data

    def _strip_network_flag(self, data: Any):
        """Remove ``__fromNetwork`` and report origin (bullet.js:161-178)."""
        if isinstance(data, dict) and data.get("__fromNetwork"):
            return {k: v for k, v in data.items() if k != "__fromNetwork"}, True
        return data, False

    def _apply_update(self, path: str, value: Any, vector_clock, from_network: bool) -> None:
        """Write store/meta/log and notify (bullet.js:184-220)."""
        parts = split_path(path)
        if not parts:
            return
        node = self.store
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value

        now_ms = int(time.time() * 1000)
        meta = dict(self.meta.get(path) or {})
        meta.update(
            source="network" if from_network else "local",
            vectorClock=vector_clock,
            lastModified=now_ms,
        )
        self.meta[path] = meta
        # this write replaced path's WHOLE subtree: descendant metas now
        # describe values that no longer exist (stale clocks there ship
        # through _leaf_meta and can freeze anti-entropy into permanent
        # splits). O(1) when there are none — the hot scalar-leaf case.
        for stale in self.meta.descendants(path):
            del self.meta[stale]

        self.log.append(
            {
                "op": "set",
                "path": path,
                "data": value,
                "vectorClock": vector_clock,
                "timestamp": now_ms,
            }
        )
        if len(self.log) > 1000:
            del self.log[: len(self.log) - 1000]

        self._notify(path, value)

    def _notify(self, path: str, data: Any) -> None:
        """Exact + ancestor listener dispatch (bullet.js:227-266) and the
        debounced save for non-file storage."""
        if not self.listeners:
            # no listeners anywhere: skip the ancestor walk (hot — every
            # put pays ~depth joins otherwise); the debounce below still
            # runs for storage-backed instances
            if self.storage is not None and self.options["storage_type"] != "file":
                if self._save_timer is not None:
                    self._save_timer.cancel()
                self._save_timer = threading.Timer(1.0, self.storage.save)
                self._save_timer.daemon = True
                self._save_timer.start()
            return
        for callback in list(self.listeners.get(path, ())):
            try:
                callback(data)
            except Exception as err:  # noqa: BLE001 - listener errors are isolated
                self._report_error(f"listener callback for {path}", err)

        for parent in ancestors(path):
            if self.listeners.get(parent):
                parent_data = self._get_data(parent)
                for callback in list(self.listeners[parent]):
                    try:
                        callback(parent_data)
                    except Exception as err:  # noqa: BLE001
                        self._report_error(f"parent listener for {parent}", err)

        if self.storage is not None and self.options["storage_type"] != "file":
            if self._save_timer is not None:
                self._save_timer.cancel()
            self._save_timer = threading.Timer(1.0, self.storage.save)
            self._save_timer.daemon = True
            self._save_timer.start()

    def _report_error(self, context: str, err: Exception) -> None:
        if self.middleware is not None:
            self.middleware.emit_event("error", {"context": context, "error": err})

    # ------------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Shut down timers, storage, and network (bullet.js:288-304)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._save_timer is not None:
                self._save_timer.cancel()
            if self.storage is not None:
                self.storage.close()
            if self.network is not None:
                self.network.close()
            self.listeners = {}

    def __enter__(self) -> "Bullet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ facade: querying

    def index(self, path: str, field: Optional[str] = None) -> "Bullet":
        if self.query is not None:
            self.query.index(path, field)
        return self

    def equals(self, path: str, *args):
        if self.query is None:
            return []
        return self.query.equals(path, *args)

    def range(self, path: str, *args):
        if self.query is None:
            return []
        return self.query.range(path, *args)

    def filter(self, path: str, filter_fn):
        if self.query is None:
            return []
        return self.query.filter(path, filter_fn)

    def find(self, path: str, predicate_fn):
        if self.query is None:
            return None
        return self.query.find(path, predicate_fn)

    def count(self, path: str, *args) -> int:
        if self.query is None:
            return 0
        return self.query.count(path, *args)

    def map(self, path: str, map_fn):
        if self.query is None:
            return []
        return self.query.map(path, map_fn)

    # ---------------------------------------------------- facade: validation

    def define_schema(self, name: str, schema: dict) -> "Bullet":
        if self.validation is not None:
            self.validation.define_schema(name, schema)
        return self

    def apply_schema(self, path: str, schema_name: str) -> "Bullet":
        if self.validation is not None:
            self.validation.apply_schema(path, schema_name)
        return self

    def validate(self, schema_name: str, data: Any) -> bool:
        if self.validation is None:
            return True
        return self.validation.validate(schema_name, data)

    def on_validation_error(self, error_type: str, handler) -> "Bullet":
        if self.validation is not None:
            self.validation.on_error(error_type, handler)
        return self

    # ---------------------------------------------------- facade: middleware

    def use(self, operation: str, middleware_fn) -> "Bullet":
        if self.middleware is not None:
            self.middleware.use(operation, middleware_fn)
        return self

    def on_get(self, fn) -> "Bullet":
        return self.use("get", fn)

    def after_get(self, fn) -> "Bullet":
        return self.use("afterGet", fn)

    def before_put(self, fn) -> "Bullet":
        return self.use("put", fn)

    def after_put(self, fn) -> "Bullet":
        return self.use("afterPut", fn)

    def before_delete(self, fn) -> "Bullet":
        return self.use("delete", fn)

    def after_delete(self, fn) -> "Bullet":
        return self.use("afterDelete", fn)

    def on(self, event: str, listener) -> "Bullet":
        if self.middleware is not None:
            self.middleware.on(event, listener)
        return self

    # -------------------------------------------------- facade: serialization

    def export_to_json(self, path: str = "", options: Optional[dict] = None) -> str:
        if self.serializer is None:
            import json

            return json.dumps(self._get_data(path))
        return self.serializer.export_to_json(path, options)

    def import_from_json(self, json_str: str, target_path=None, options=None) -> dict:
        if self.serializer is None:
            import json

            try:
                data = json.loads(json_str)
                self.set_data(target_path, data)
                return {"success": True, "path": target_path, "data": data}
            except Exception as err:  # noqa: BLE001
                return {"success": False, "error": str(err)}
        return self.serializer.import_from_json(json_str, target_path, options)

    def export_to_csv(self, path: str, options=None) -> str:
        if self.serializer is None:
            return ""
        return self.serializer.export_to_csv(path, options)

    def import_from_csv(self, csv_str: str, target_path: str, options=None) -> dict:
        if self.serializer is None:
            return {"success": False, "error": "Serializer not enabled"}
        return self.serializer.import_from_csv(csv_str, target_path, options)

    def export_to_xml(self, path: str, options=None) -> str:
        if self.serializer is None:
            return ""
        return self.serializer.export_to_xml(path, options)

    def import_from_xml(self, xml_str: str, target_path: str, options=None) -> dict:
        if self.serializer is None:
            return {"success": False, "error": "Serializer not enabled"}
        return self.serializer.import_from_xml(xml_str, target_path, options)

    def register_serializer_type(self, type_name, serializer_fn, deserializer_fn) -> "Bullet":
        if self.serializer is not None:
            self.serializer.register_type(type_name, serializer_fn, deserializer_fn)
        return self

    # camelCase aliases (reference API names, bullet.js facades :313-675)
    defineSchema = define_schema
    applySchema = apply_schema
    onValidationError = on_validation_error
    onGet = on_get
    afterGet = after_get
    beforePut = before_put
    afterPut = after_put
    exportToJSON = export_to_json
    importFromJSON = import_from_json
    exportToCSV = export_to_csv
    importFromCSV = import_from_csv
    exportToXML = export_to_xml
    importFromXML = import_from_xml
    registerSerializerType = register_serializer_type


class BulletNode:
    """Chainable cursor over a path (bullet.js:681-759)."""

    def __init__(self, bullet: Bullet, path: str) -> None:
        self.bullet = bullet
        self.path = normalize(path)

    def value(self) -> Any:
        return self.bullet._get_data(self.path)

    def put(self, data: Any) -> "BulletNode":
        self.bullet.set_data(self.path, data)
        return self

    def on(self, callback: Callable[[Any], None]) -> "BulletNode":
        self.bullet.listeners.setdefault(self.path, []).append(callback)
        callback(self.value())  # fires immediately (bullet.js:717)
        return self

    def get(self, child_path: str) -> "BulletNode":
        full = f"{self.path}/{child_path}" if self.path else child_path
        return BulletNode(self.bullet, full)

    def off(self, callback: Optional[Callable] = None) -> "BulletNode":
        callbacks = self.bullet.listeners.get(self.path)
        if callbacks:
            if callback is None:
                self.bullet.listeners[self.path] = []
            elif callback in callbacks:
                callbacks.remove(callback)
        return self

    def remove(self) -> "BulletNode":
        self.bullet.set_data(self.path, None)
        return self

    def delete(self) -> "BulletNode":
        """Hookable delete (installed by middleware in the reference,
        bullet-middleware.js:137-186); without middleware it's ``remove``."""
        mw = self.bullet.middleware
        if mw is None:
            return self.remove()
        return mw.run_delete(self)
