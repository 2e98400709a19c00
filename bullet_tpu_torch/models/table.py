"""Host bridge between path-addressed JSON values and the device tables.

Owns the global interners (paths, values) shared by every simulated peer —
which is what makes slot ids and value ids agree across replicas so the
device merge is meaningful (DESIGN.md). Handles leaf decomposition (object
puts become per-leaf ops, mirroring the bullet-js sync wire format), tree
reconstruction for reads, capacity growth, and re-keying after a
string-rank rebalance.

The interners are the port's own copies of the reference package's
numpy/native ones (``utils/``, ``native/``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..ops.scans import PathStruct
from ..utils.encode import ValueInterner
from ..utils.paths import PathInterner


def flatten_value(path: str, value: Any) -> Iterator[Tuple[str, Any]]:
    """Decompose a put into leaf (path, value) pairs. Dicts recurse; scalars,
    arrays and None are leaves; empty dicts produce nothing (the reference's
    store traversal also never emits them)."""
    if isinstance(value, dict):
        for key, sub in value.items():
            yield from flatten_value(f"{path}/{key}" if path else str(key), sub)
    else:
        yield path, value


class GraphHost:
    """Shared host-side structure for a simulation.

    The path interner is the native C++ one when the toolchain is available
    (bulk ingestion of novel paths runs in one C call; see
    native/pathintern.cpp) with the pure-Python PathInterner as fallback —
    ids, segment ids, and tree structure are bit-identical either way.
    """

    def __init__(self, capacity: int = 1024) -> None:
        from ..native import make_path_interner

        self.paths = make_path_interner()
        self._native_paths = not isinstance(self.paths, PathInterner)
        self.values = ValueInterner()
        self.capacity = capacity
        # per-slot structure (numpy, mirrored per device on demand); in
        # native mode these export in bulk from C++ instead of growing in
        # place
        self._parent = np.full(capacity, -1, dtype=np.int32)
        self._parent2 = np.full(capacity, -1, dtype=np.int32)
        self._seg = np.full(capacity, -1, dtype=np.int32)
        self._seg_ids: Dict[str, int] = {}
        self._np_dirty = True
        # struct() per device, emptied whenever the paths or the capacity
        # change
        self._structs: Dict[torch.device, PathStruct] = {}
        self.values.on_rebalance(self._mark_rekey)
        self.needs_rekey = False

    # ------------------------------------------------------------- interning

    def _seg_id(self, seg: str) -> int:
        if self._native_paths:
            return self.paths.seg_id(seg)
        sid = self._seg_ids.get(seg)
        if sid is None:
            sid = len(self._seg_ids)
            self._seg_ids[seg] = sid
        return sid

    def intern_path(self, path: str) -> int:
        before = len(self.paths)
        pid = self.paths.intern(path)
        if len(self.paths) != before:
            self._grow_to(len(self.paths))
            if not self._native_paths:
                for new_pid in range(before, len(self.paths)):
                    parent = self.paths.parent(new_pid)
                    self._parent[new_pid] = parent
                    self._parent2[new_pid] = (
                        self.paths.parent(parent) if parent >= 0 else -1
                    )
                    self._seg[new_pid] = self._seg_id(self.paths.segment(new_pid))
            self._paths_changed()
        return pid

    def intern_batch(self, paths) -> np.ndarray:
        """Vectorized path interning: int32 slot ids for a list of paths.
        Native mode does the whole batch in one C call (~10M paths/s);
        the fallback loops with a memo."""
        if self._native_paths:
            before = len(self.paths)
            slots = self.paths.intern_batch(paths)
            if len(self.paths) != before:
                self._grow_to(len(self.paths))
                self._paths_changed()
            return slots
        memo: Dict[str, int] = {}
        slots = np.empty(len(paths), dtype=np.int32)
        for i, p in enumerate(paths):
            s = memo.get(p)
            if s is None:
                s = memo[p] = self.intern_path(p)
            slots[i] = s
        return slots

    def _grow_to(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if not self._native_paths:
            for name in ("_parent", "_parent2", "_seg"):
                old = getattr(self, name)
                grown = np.full(new_cap, -1, dtype=np.int32)
                grown[: old.shape[0]] = old
                setattr(self, name, grown)
        self.capacity = new_cap
        self._paths_changed()

    def _paths_changed(self) -> None:
        self._np_dirty = True
        self._structs.clear()

    def encode_value(self, value: Any) -> Tuple[int, int, int, int]:
        return self.values.encode(value)

    def _mark_rekey(self) -> None:
        self.needs_rekey = True

    # -------------------------------------------------------------- exports

    def _refresh_struct_host(self) -> None:
        if self._native_paths and self._np_dirty:
            parent, seg = self.paths.export_struct(self.capacity)
            parent2 = np.full(self.capacity, -1, dtype=np.int32)
            has_parent = parent >= 0
            parent2[has_parent] = parent[parent[has_parent]]
            self._parent, self._parent2, self._seg = parent, parent2, seg
        self._np_dirty = False

    def struct(self, device) -> PathStruct:
        """The path structure on ``device`` (cached per device until the
        paths or the capacity change; a mesh whose devices repeat keeps
        one copy per distinct device)."""
        device = torch.device(device)
        cached = self._structs.get(device)
        if cached is None:
            cached = self._structs[device] = PathStruct(*(
                torch.from_numpy(a.copy()).to(device) for a in self.struct_np()))
        return cached

    def struct_np(self):
        """(parent, parent2, seg) as host numpy arrays (tree assembly): no
        device transfers, unlike struct()."""
        self._refresh_struct_host()
        return self._parent, self._parent2, self._seg

    def seg_lookup(self, seg: str) -> int:
        if self._native_paths:
            return self.paths.seg_lookup(seg)
        return self._seg_ids.get(seg, -1)

    def key_tables(self):
        return self.values.key_table()

    # ---------------------------------------------------------------- reads

    def leaf_slots_under(self, pid: int) -> List[int]:
        if self._native_paths:
            return self.paths.subtree(pid).tolist()
        return [d for d in self.paths.descendants(pid)]

    def build_tree(
        self, pid: int, slot_values: Dict[int, Any]
    ) -> Any:
        """Reassemble the subtree rooted at ``pid`` from decoded leaf values.

        ``slot_values`` maps slot id -> decoded value for present leaves.
        Returns the leaf value when ``pid`` itself is a populated leaf with no
        populated descendants; otherwise a nested dict.

        Flat bottom-up assembly (ids ascend parent-before-child, so a single
        descending pass sees every child before its parent) — no recursion
        and, in native mode, no per-node children() round-trips: the subtree
        arrives as one bulk call and parents come from the cached numpy
        array. A node with populated children is a dict (leaf value
        shadowed); childless populated nodes are their value.
        """
        ids = [pid, *self.leaf_slots_under(pid)]
        ids.sort()
        parent_arr, _, _ = self.struct_np()
        seg = self.paths.segment
        pending: Dict[int, list] = {}
        for i in reversed(ids):
            kids = pending.pop(i, None)
            if kids is not None:
                node: Any = {s: sub for s, sub in reversed(kids)}
            elif i in slot_values:
                node = slot_values[i]
            else:
                continue
            if i == pid:
                return node
            par = int(parent_arr[i])
            bucket = pending.get(par)
            if bucket is None:
                bucket = pending[par] = []
            bucket.append((seg(i), node))
        return _MISSING


class _Missing:
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<missing>"


_MISSING = _Missing()
MISSING = _MISSING
