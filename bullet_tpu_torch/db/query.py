"""Query and indexing for the host db layer.

Behavioral twin of bullet-js src/bullet-query.js: hash indexes keyed
``path:field`` or ``path`` mapping stringified values → sets of node paths
(:30-45, :126-131), maintained by diffing old/new field values on writes
(:139-176) and built lazily on first query (:194-196). ``equals``/``count``
are index lookups, ``range`` iterates index keys with numeric coercion
(:221-261), ``filter``/``find``/``map`` scan children.

The engine's vectorized scans live in ``bullet_tpu_torch.ops.scans``; this
module is the single-process API the reference exposes.

The port's own copy of ``bullet_tpu/db/query.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Set

from ..utils.jsvalues import to_string

_UNSET = object()  # stands in for the reference's arguments.length dispatch


class BulletQuery:
    def __init__(self, bullet) -> None:
        self.bullet = bullet
        self.indices: Dict[str, Dict[str, Set[str]]] = {}
        self.indexed_paths: Set[str] = set()

    # ------------------------------------------------------------- index admin

    def index(self, path: str, field: Optional[str] = None) -> "BulletQuery":
        index_key = f"{path}:{field}" if field else path
        if index_key in self.indices:
            return self
        self.indices[index_key] = {}
        self.indexed_paths.add(path)
        self._build_index(path, field)
        return self

    def _build_index(self, path: str, field: Optional[str]) -> None:
        """Full scan build (bullet-query.js:53-73)."""
        index_key = f"{path}:{field}" if field else path
        idx = self.indices[index_key]
        base = self.bullet._get_data(path)
        if not isinstance(base, dict):
            return
        for key, value in base.items():
            if field:
                if isinstance(value, dict) and field in value:
                    self._add_to_index(idx, value[field], f"{path}/{key}")
            else:
                self._add_to_index(idx, value, f"{path}/{key}")

    @staticmethod
    def _indexable_value(value: Any) -> str:
        """Stringified index key (bullet-query.js:126-131)."""
        if isinstance(value, (dict, list)):
            return json.dumps(value, separators=(",", ":"))
        return to_string(value)

    def _add_to_index(self, idx: Dict[str, Set[str]], value: Any, node_path: str) -> None:
        if value is None:
            return
        idx.setdefault(self._indexable_value(value), set()).add(node_path)

    def _remove_from_index(self, idx: Dict[str, Set[str]], value: Any, node_path: str) -> None:
        if value is None:
            return
        key = self._indexable_value(value)
        paths = idx.get(key)
        if paths is not None:
            paths.discard(node_path)
            if not paths:
                del idx[key]

    def _update_indices(self, path: str, new_data: Any) -> None:
        """Write-path maintenance (bullet-query.js:139-176). Called after the
        write has been applied, so the "old" value is read from the already
        merged store like the reference does (making this effectively an
        add-only diff, matching reference behavior)."""
        for indexed_path in self.indexed_paths:
            if not path.startswith(indexed_path + "/"):
                continue
            relative = path[len(indexed_path) + 1 :]
            parts = relative.split("/")
            for index_key, idx in self.indices.items():
                base_path, _, field = index_key.partition(":")
                if base_path != indexed_path:
                    continue
                if field and len(parts) == 1:
                    old_data = self.bullet._get_data(f"{indexed_path}/{parts[0]}")
                    if isinstance(old_data, dict) and old_data.get(field):
                        self._remove_from_index(
                            idx, old_data[field], f"{indexed_path}/{parts[0]}"
                        )
                    if isinstance(new_data, dict) and new_data.get(field):
                        self._add_to_index(
                            idx, new_data[field], f"{indexed_path}/{parts[0]}"
                        )
                elif not field and len(parts) == 1:
                    old_data = self.bullet._get_data(path)
                    self._remove_from_index(idx, old_data, path)
                    self._add_to_index(idx, new_data, path)

    # ----------------------------------------------------------------- queries

    def _ensure_index(self, path: str, field: Optional[str]) -> Dict[str, Set[str]]:
        index_key = f"{path}:{field}" if field else path
        if index_key not in self.indices:
            self.index(path, field)
        return self.indices[index_key]

    def equals(self, path: str, field, value=_UNSET):
        """Index lookup (bullet-query.js:186-210). Two-arg form matches the
        reference overload: ``equals(path, value)``."""
        if value is _UNSET:
            field, value = None, field
        idx = self._ensure_index(path, field)
        key = self._indexable_value(value)
        return [self.bullet.get(p) for p in sorted(idx.get(key, ()))]

    def range(self, path: str, field, min_value=_UNSET, max_value=_UNSET):
        """Range scan over index keys with numeric coercion
        (bullet-query.js:221-261). Three-arg form: ``range(path, min, max)``."""
        if max_value is _UNSET:
            field, min_value, max_value = None, field, min_value
        if min_value is _UNSET or max_value is _UNSET:
            return []
        idx = self._ensure_index(path, field)
        results = []
        for index_value, paths in idx.items():
            try:
                value: Any = float(index_value)
            except (TypeError, ValueError):
                value = index_value
            try:
                if min_value is not None and max_value is not None:
                    if value >= min_value and value <= max_value:
                        results.extend(self.bullet.get(p) for p in sorted(paths))
            except TypeError:
                continue  # mixed-type comparison: JS would coerce; skip
        return results

    def filter(self, path: str, filter_fn: Callable):
        """Full child scan with predicate (bullet-query.js:270-283)."""
        base = self.bullet._get_data(path)
        results = []
        if isinstance(base, dict):
            for key, value in base.items():
                if _call_pred(filter_fn, value, key):
                    results.append(self.bullet.get(f"{path}/{key}"))
        return results

    def count(self, path: str, field, value=_UNSET) -> int:
        """Index-backed count (bullet-query.js:293-313)."""
        if value is _UNSET:
            field, value = None, field
        idx = self._ensure_index(path, field)
        return len(idx.get(self._indexable_value(value), ()))

    def map(self, path: str, map_fn: Callable):
        """Map child values (bullet-query.js:322-333)."""
        base = self.bullet._get_data(path)
        if not isinstance(base, dict):
            return []
        return [_call_pred(map_fn, value, key) for key, value in base.items()]

    def find(self, path: str, predicate_fn: Callable):
        """First matching child (bullet-query.js:342-354)."""
        base = self.bullet._get_data(path)
        if isinstance(base, dict):
            for key, value in base.items():
                if _call_pred(predicate_fn, value, key):
                    return self.bullet.get(f"{path}/{key}")
        return None


def _call_pred(fn: Callable, value, key):
    """Call with (value, key) like the reference, tolerating 1-arg callables."""
    try:
        return fn(value, key)
    except TypeError:
        return fn(value)
