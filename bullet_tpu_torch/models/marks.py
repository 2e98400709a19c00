"""The dirty-column marks of a sim's round loop, under one invariant: a
column is marked clean only where every replica holds the same entry. Such
a column is a fixed point of every topology, so the stripe loops, the
column pass and the graph pass all skip it alike. A converge that reached
the fixed point cleans every column only under a strongly connected
topology (every replica then holds its column's join); under any other the
marks stay as they are. A cutoff, a capacity change, a restore or untracked
gossip leaves them stale (every column dirty) until the next settle."""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.packed import COLUMN_GROUP
from ..parallel.topology import Topology


class ColumnMarks:
    """Dirty marks by column, bool [N], and by 16-column group. ``width()``
    gives (N, the frontier's stripe width at N); a width of 0 keeps none."""

    def __init__(self, width: Callable[[], Tuple[int, int]]) -> None:
        self._width = width
        self._cols: Optional[np.ndarray] = None  # None: stale
        self._groups: Optional[np.ndarray] = None
        self._connected: Tuple[Optional[Topology], bool] = (None, False)  # tested once a topology

    def columns(self) -> Optional[np.ndarray]:
        """The dirty columns; None where the marks are stale."""
        n, tile_n = self._width()
        return self._cols if tile_n and self._cols is not None and len(self._cols) == n else None

    def groups(self) -> Optional[np.ndarray]:
        """Ascending ids of the groups that hold a dirty column; None where stale."""
        return None if self.columns() is None else np.flatnonzero(self._groups)

    def seed(self, device) -> torch.Tensor:
        """A stripe loop's seed: the stripes that hold a dirty column (all
        where stale)."""
        n, tile_n = self._width()
        cols = self.columns()
        if cols is None:
            return torch.ones(n // tile_n, dtype=torch.bool, device=device)
        # 8 columns a word: a stripe (a multiple of 32 columns) is whole words
        return torch.from_numpy(cols.view(np.uint64).reshape(n // tile_n, -1).any(1)).to(device)

    def mark(self, slots: np.ndarray) -> None:
        if self.columns() is None:
            self.forget()
        else:
            self._cols[slots] = True
            self._groups[slots // COLUMN_GROUP] = True

    def forget(self) -> None:
        self._cols = None

    def settle(self, topology: Topology) -> None:
        """A converge reached the fixed point of ``topology``."""
        n, tile_n = self._width()
        if not tile_n:
            return
        if self._connected[0] is not topology:
            self._connected = (topology, topology.is_connected())
        if self._connected[1]:
            self._cols = np.zeros(n, dtype=bool)
            self._groups = np.zeros(n // COLUMN_GROUP, dtype=bool)

    def finish(self, rounds: int, last: int, max_rounds: int, topology: Topology) -> None:
        """After a tracked loop: settled unless its cap cut it off."""
        if rounds < max_rounds or last == 0:
            self.settle(topology)
        else:
            self.forget()
