"""Middleware hook pipeline and event bus.

Behavioral twin of bullet-js src/bullet-middleware.js: get hooks can
rewrite paths (errors are caught and surfaced as ``error`` events, the read
proceeds — :27-68); put hooks can veto with ``False``, replace the data, or
replace ``{"path":…, "data":…}`` (:70-135); delete hooks gate
``BulletNode.delete`` (:137-186). Built-in helpers: rewrite_path, transform,
encrypt_fields, access_control, log (:322-524).

Python convention for "undefined": a hook that returns ``None`` leaves the
value unchanged (mirrors ``result !== undefined`` checks).

The port's own copy of ``bullet_tpu/db/middleware.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List

OPERATIONS = ("get", "put", "afterGet", "afterPut", "delete", "afterDelete")


class BulletMiddleware:
    def __init__(self, bullet) -> None:
        self.bullet = bullet
        self.middleware: Dict[str, List[Callable]] = {op: [] for op in OPERATIONS}
        self.event_listeners: Dict[str, List[Callable]] = {}
        bullet.middleware = self

    # ------------------------------------------------------------ registration

    def use(self, operation: str, middleware: Callable) -> "BulletMiddleware":
        if operation not in self.middleware:
            raise ValueError(f"Unknown operation: {operation}")
        if not callable(middleware):
            raise TypeError("Middleware must be a function")
        self.middleware[operation].append(middleware)
        return self

    def on_get(self, fn) -> "BulletMiddleware":
        return self.use("get", fn)

    def after_get(self, fn) -> "BulletMiddleware":
        return self.use("afterGet", fn)

    def before_put(self, fn) -> "BulletMiddleware":
        return self.use("put", fn)

    def after_put(self, fn) -> "BulletMiddleware":
        return self.use("afterPut", fn)

    def before_delete(self, fn) -> "BulletMiddleware":
        return self.use("delete", fn)

    def after_delete(self, fn) -> "BulletMiddleware":
        return self.use("afterDelete", fn)

    onGet = on_get
    afterGet = after_get
    beforePut = before_put
    afterPut = after_put
    beforeDelete = before_delete
    afterDelete = after_delete

    # ------------------------------------------------------------------ events

    def on(self, event: str, listener: Callable) -> "BulletMiddleware":
        self.event_listeners.setdefault(event, []).append(listener)
        return self

    def emit_event(self, event: str, data: Any = None) -> None:
        """Per-event listeners then "all" listeners; listener errors are
        isolated (bullet-middleware.js:293-313)."""
        for listener in list(self.event_listeners.get(event, ())):
            try:
                listener(data)
            except Exception:  # noqa: BLE001
                pass
        for listener in list(self.event_listeners.get("all", ())):
            try:
                listener(event, data)
            except Exception:  # noqa: BLE001
                pass

    emitEvent = emit_event

    # ------------------------------------------------------------- read hooks

    def wrapped_get(self, path: str, raw_getter: Callable[[str], Any]) -> Any:
        """Get-hook pipeline (bullet-middleware.js:27-68): hook errors are
        caught (the read continues), afterGet hooks may rewrite the data, and
        a "read" event always fires."""
        modified_path = path
        for mw in self.middleware["get"]:
            try:
                result = mw(modified_path)
                if isinstance(result, str):
                    modified_path = result
            except Exception as error:  # noqa: BLE001
                self.emit_event(
                    "error", {"operation": "get", "path": modified_path, "error": error}
                )

        data = raw_getter(modified_path)

        for mw in self.middleware["afterGet"]:
            try:
                result = mw(modified_path, data)
                if result is not None:
                    data = result
            except Exception as error:  # noqa: BLE001
                self.emit_event(
                    "error",
                    {
                        "operation": "afterGet",
                        "path": modified_path,
                        "data": data,
                        "error": error,
                    },
                )

        self.emit_event("read", {"path": modified_path, "data": data})
        return data

    # ------------------------------------------------------------ write hooks

    def run_put_hooks(self, path: str, data: Any):
        """Put-hook pipeline (bullet-middleware.js:70-105). Returns
        ``(should_continue, path, data)``; a hook error vetoes the write."""
        modified_path, modified_data = path, data
        for mw in self.middleware["put"]:
            try:
                result = mw(modified_path, modified_data)
            except Exception as error:  # noqa: BLE001
                self.emit_event(
                    "error",
                    {
                        "operation": "put",
                        "path": modified_path,
                        "data": modified_data,
                        "error": error,
                    },
                )
                return False, modified_path, modified_data
            if result is False:
                return False, modified_path, modified_data
            if result is not None:
                if isinstance(result, dict) and "path" in result and "data" in result:
                    modified_path = result["path"]
                    modified_data = result["data"]
                else:
                    modified_data = result
        return True, modified_path, modified_data

    def run_after_put_hooks(self, path: str, data: Any, old_data: Any) -> None:
        """afterPut hooks + "write" event (bullet-middleware.js:112-131)."""
        for mw in self.middleware["afterPut"]:
            try:
                mw(path, data, old_data)
            except Exception as error:  # noqa: BLE001
                self.emit_event(
                    "error",
                    {
                        "operation": "afterPut",
                        "path": path,
                        "data": data,
                        "oldData": old_data,
                        "error": error,
                    },
                )
        self.emit_event("write", {"path": path, "data": data, "oldData": old_data})

    def run_delete(self, node):
        """delete/afterDelete pipeline for ``BulletNode.delete``
        (bullet-middleware.js:137-186): delete = put(None) when allowed."""
        path = node.path
        for mw in self.middleware["delete"]:
            try:
                if mw(path) is False:
                    return node
            except Exception as error:  # noqa: BLE001
                self.emit_event(
                    "error", {"operation": "delete", "path": path, "error": error}
                )
                return node

        old_data = self.bullet._get_data(path)
        self.bullet.set_data(path, None)

        for mw in self.middleware["afterDelete"]:
            try:
                mw(path, old_data)
            except Exception as error:  # noqa: BLE001
                self.emit_event(
                    "error",
                    {
                        "operation": "afterDelete",
                        "path": path,
                        "oldData": old_data,
                        "error": error,
                    },
                )
        self.emit_event("delete", {"path": path, "oldData": old_data})
        return node

    # ---------------------------------------------------------------- helpers

    @staticmethod
    def _matcher(path_pattern):
        if isinstance(path_pattern, str):
            return lambda p: p == path_pattern or p.startswith(path_pattern + "/")
        return lambda p: bool(path_pattern.search(p))

    def rewrite_path(self, pattern, replacement) -> "BulletMiddleware":
        """Path rewrite on reads (bullet-middleware.js:322-337). Matches the
        reference's String.replace semantics: first occurrence only, callbacks
        receive ``(match, group1, ...)``, string replacements use ``$1``."""
        regex = re.compile(pattern) if isinstance(pattern, str) else pattern

        if callable(replacement):
            def apply(path):
                return regex.sub(
                    lambda m: replacement(m.group(0), *m.groups()), path, count=1
                )
        else:
            # JS String.replace replacement grammar: "$$" is a literal "$",
            # "$n"/"$nn" is a group reference (out-of-range refs stay
            # literal, a 2-digit ref falls back to 1 digit + literal),
            # backslashes have no special meaning. Expanding via a callable
            # sidesteps Python's re.sub escaping entirely — "$$1" stays the
            # literal "$1" and "\" survives untouched.
            tokens = re.split(r"(\$\$|\$\d{1,2})", replacement)

            def expand_token(tok: str, m) -> str:
                if tok == "$$":
                    return "$"
                if len(tok) > 1 and tok[0] == "$" and tok[1:].isdigit():
                    digits, n = tok[1:], len(m.groups())
                    if len(digits) == 2 and 1 <= int(digits) <= n:
                        return m.group(int(digits)) or ""
                    if 1 <= int(digits[0]) <= n:
                        return (m.group(int(digits[0])) or "") + digits[1:]
                return tok

            def apply(path):
                return regex.sub(
                    lambda m: "".join(expand_token(t, m) for t in tokens),
                    path,
                    count=1,
                )

        def hook(path):
            if isinstance(path, str):
                return apply(path)
            return path

        return self.on_get(hook)

    def transform(self, path_pattern, transform_fn, direction: str = "both"):
        """Data transform on read/write/both (bullet-middleware.js:347-372)."""
        matcher = self._matcher(path_pattern)
        if direction in ("read", "both"):
            self.after_get(
                lambda path, data: transform_fn(data, path, "read") if matcher(path) else data
            )
        if direction in ("write", "both"):
            self.before_put(
                lambda path, data: transform_fn(data, path, "write") if matcher(path) else data
            )
        return self

    def encrypt_fields(self, path_pattern, fields, encrypt_fn, decrypt_fn):
        """Field-level encryption (bullet-middleware.js:383-434)."""
        matcher = self._matcher(path_pattern)

        def encrypt(path, data):
            if not matcher(path) or not isinstance(data, dict):
                return data
            result = dict(data)
            for f in fields:
                if result.get(f) is not None:
                    result[f] = encrypt_fn(result[f])
            return result

        def decrypt(path, data):
            if not matcher(path) or not isinstance(data, dict):
                return data
            result = dict(data)
            for f in fields:
                if result.get(f) is not None:
                    try:
                        result[f] = decrypt_fn(result[f])
                    except Exception:  # noqa: BLE001
                        pass
            return result

        self.before_put(encrypt)
        self.after_get(decrypt)
        return self

    def access_control(self, path_pattern, check_fn, operations=("read", "write", "delete")):
        """Access control (bullet-middleware.js:444-491). Note: like the
        reference, read denial raises inside a caught get hook, so it surfaces
        as an ``error`` event rather than blocking the read; write/delete
        denial does block."""
        matcher = self._matcher(path_pattern)

        if "read" in operations:

            def check_read(path):
                if matcher(path) and not check_fn(path, "read"):
                    raise PermissionError(f"Access denied for reading path: {path}")
                return path

            self.on_get(check_read)

        if "write" in operations:

            def check_write(path, data):
                if matcher(path) and not check_fn(path, "write", data):
                    raise PermissionError(f"Access denied for writing to path: {path}")
                return data

            self.before_put(check_write)

        if "delete" in operations:

            def check_delete(path):
                if matcher(path) and not check_fn(path, "delete"):
                    raise PermissionError(f"Access denied for deleting path: {path}")
                return True

            self.before_delete(check_delete)
        return self

    def log(self, operations=("read", "write", "delete"), log_fn=print):
        """Operation logging (bullet-middleware.js:500-524)."""
        if "read" in operations:

            def log_read(path, data):
                log_fn(f"READ: {path}", data)
                return data

            self.after_get(log_read)
        if "write" in operations:
            self.after_put(lambda path, data, old: log_fn(f"WRITE: {path}", {"old": old, "new": data}))
        if "delete" in operations:
            self.after_delete(lambda path, old: log_fn(f"DELETE: {path}", old))
        return self

    # camelCase helper aliases
    rewritePath = rewrite_path
    encryptFields = encrypt_fields
    accessControl = access_control
