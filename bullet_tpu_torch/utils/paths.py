"""Path handling and interning.

The reference addresses nodes by slash-separated paths
(``bullet-js src/bullet.js:115-129``). The engine needs dense
integer ids for leaf paths so the graph lives in fixed-shape device tables;
this module provides normalization plus a host-side interner that also tracks
the parent/child tree so subtree reads and per-parent query scans stay cheap.

The port's own copy of ``bullet_tpu/utils/paths.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


_SPLIT_CACHE: Dict[str, Tuple[str, ...]] = {}


def split_path(path: str) -> Tuple[str, ...]:
    """Split a path into non-empty segments (mirrors ``path.split("/").filter(Boolean)``,
    bullet-js src/bullet.js:118). Memoized — the write path splits
    the same paths 6+ times per put; the immutable tuple makes the cache
    alias-safe. Bounded (clears at 64k entries)."""
    parts = _SPLIT_CACHE.get(path)
    if parts is None:
        if len(_SPLIT_CACHE) >= 1 << 16:
            _SPLIT_CACHE.clear()
        parts = tuple(p for p in path.split("/") if p)
        _SPLIT_CACHE[path] = parts
    return parts


def join_path(parts) -> str:
    return "/".join(parts)


def normalize(path: str) -> str:
    return join_path(split_path(path))


def parent_path(path: str) -> Optional[str]:
    parts = split_path(path)
    if not parts:
        return None
    return join_path(parts[:-1])


def ancestors(path: str) -> Iterator[str]:
    """Yield every proper ancestor path, nearest first, ending with "" (root).

    Mirrors the parent-notification walk in bullet-js src/bullet.js:238-256.
    """
    parts = split_path(path)
    while parts:
        parts = parts[:-1]
        yield join_path(parts)


class PathInterner:
    """Bidirectional path <-> dense id map with tree structure.

    Ids are assigned in first-intern order and are stable for the lifetime of
    the interner. A single interner is shared by every simulated peer so slot
    ids agree across the whole simulation.
    """

    def __init__(self) -> None:
        self._id_of: Dict[str, int] = {}
        self._path_of: List[str] = []
        self._parent: List[int] = []  # parent path id, -1 for top-level
        self._last_seg: List[str] = []
        self._children: Dict[int, List[int]] = {}

    def __len__(self) -> int:
        return len(self._path_of)

    def __contains__(self, path: str) -> bool:
        return normalize(path) in self._id_of

    def intern(self, path: str) -> int:
        """Return the id for ``path``, creating it (and its ancestors) if new."""
        path = normalize(path)
        existing = self._id_of.get(path)
        if existing is not None:
            return existing
        parts = split_path(path)
        parent_id = -1
        prefix: List[str] = []
        for seg in parts:
            prefix.append(seg)
            p = join_path(prefix)
            pid = self._id_of.get(p)
            if pid is None:
                pid = len(self._path_of)
                self._id_of[p] = pid
                self._path_of.append(p)
                self._parent.append(parent_id)
                self._last_seg.append(seg)
                if parent_id >= 0:
                    self._children.setdefault(parent_id, []).append(pid)
            parent_id = pid
        return parent_id

    def lookup(self, path: str) -> Optional[int]:
        return self._id_of.get(normalize(path))

    def lookup_batch(self, paths) -> "np.ndarray":
        """int32 ids [K], -1 = unknown (API twin of the native batch)."""
        import numpy as np

        get = self._id_of.get
        return np.fromiter(
            (get(normalize(p), -1) for p in paths),
            dtype=np.int32,
            count=len(paths),
        )

    def path(self, pid: int) -> str:
        return self._path_of[pid]

    def paths_batch(self, pids) -> List[str]:
        """K path strings for K ids in one pass (batch twin of ``path``,
        API parity with the native interner)."""
        if hasattr(pids, "tolist"):
            pids = pids.tolist()
        return list(map(self._path_of.__getitem__, pids))

    def parent(self, pid: int) -> int:
        return self._parent[pid]

    def parents_batch(self, pids) -> "np.ndarray":
        """int32 parent ids [K] (batch twin of ``parent``)."""
        import numpy as np

        return np.asarray(self._parent, dtype=np.int32)[
            np.asarray(pids, dtype=np.int64)
        ]

    def segment(self, pid: int) -> str:
        return self._last_seg[pid]

    def children(self, pid: int) -> List[int]:
        return list(self._children.get(pid, ()))

    def child(self, pid: int, seg: str) -> Optional[int]:
        base = self._path_of[pid] if pid >= 0 else ""
        return self._id_of.get(f"{base}/{seg}" if base else seg)

    def descendants(self, pid: int) -> Iterator[int]:
        """Yield all strict descendants of ``pid`` (DFS order)."""
        stack = self.children(pid)
        while stack:
            cur = stack.pop()
            yield cur
            stack.extend(self._children.get(cur, ()))

    def top_level(self) -> List[int]:
        return [i for i, p in enumerate(self._parent) if p == -1]

    def items(self) -> Iterator[Tuple[str, int]]:
        return iter(self._id_of.items())
