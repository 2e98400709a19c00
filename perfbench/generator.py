"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and draws each iteration of the closed loop from the run's seed.

An iteration is a batch of updates, then ``reads_per_batch`` reads. Batch
``t`` is drawn from its own stream, ``(seed, t)``, so it is the same whatever
came before it. Every update picks a record by YCSB's scrambled Zipfian, a
field and a peer uniformly; every read picks a record, a field and a peer
the same way, and is made by the read kind the mix names
(``perfbench/reads/<read>.py``).

Values: a write of batch ``t`` carries ``t * value_draws + u``, with ``u``
drawn uniformly below ``value_draws``: values grow from batch to batch, so
the table keeps changing, and concurrent writes to one leaf carry different
values, so the CRT's rule decides between them.

A mix's keys: ``why``, ``updates_per_batch`` (at least 1),
``reads_per_batch``, ``read`` (a read kind, needed where there are reads)
and ``value_draws`` (at least 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ycsb import ScrambledZipfian

KEYS = {"why", "updates_per_batch", "reads_per_batch", "read", "value_draws"}


@dataclass
class Iteration:
    t: int
    peers: np.ndarray  # int32 [K] writer of each update
    leaves: np.ndarray  # int64 [K] record * fields + field
    values: np.ndarray  # int64 [K]
    read_peers: np.ndarray  # int32 [R]
    read_records: np.ndarray  # int64 [R]
    read_fields: np.ndarray  # int64 [R]


class Traffic:
    """A closed-loop YCSB-style mix over ``records`` records of ``fields``
    fields held by ``peers`` replicas."""

    def __init__(self, mix: dict, records: int, fields: int, peers: int, seed: int) -> None:
        unknown = set(mix) - KEYS
        if unknown:
            raise ValueError(f"traffic mix has unknown keys {sorted(unknown)}")
        self.updates = int(mix["updates_per_batch"])
        self.reads = int(mix.get("reads_per_batch", 0))
        self.value_draws = int(mix["value_draws"])
        if self.updates < 1 or self.reads < 0 or self.value_draws < 1:
            raise ValueError(f"traffic sizes: {self.updates} updates, {self.reads} reads, "
                             f"{self.value_draws} value draws")
        self.read = mix.get("read")
        if self.reads and not self.read:
            raise ValueError("a mix with reads names its read kind")
        self.records, self.fields, self.peers = records, fields, peers
        self.seed = int(seed)
        self._records = ScrambledZipfian(records)

    def rng(self, t: int) -> np.random.Generator:
        # NumPy takes non-negative entropy of any width; the sign goes apart
        return np.random.default_rng([abs(self.seed), int(self.seed < 0), int(t)])

    def iteration(self, t: int) -> Iteration:
        rng = self.rng(t)
        k = self.updates
        records = self._records.draw(rng, k)
        fields = rng.integers(0, self.fields, k)
        peers = rng.integers(0, self.peers, k).astype(np.int32)
        values = int(t) * self.value_draws + rng.integers(0, self.value_draws, k)
        read_records = self._records.draw(rng, self.reads)
        read_fields = rng.integers(0, self.fields, self.reads)
        read_peers = rng.integers(0, self.peers, self.reads).astype(np.int32)
        return Iteration(t, peers, records * self.fields + fields, values.astype(np.int64),
                         read_peers, read_records, read_fields)
