"""Conflict resolution with per-path vector clocks — reference-exact semantics.

This is the host-side twin of the engine's lexicographic-max kernel: it keeps
full vector clocks and reproduces the complete decision table of
``resolve`` (bullet-js src/bullet-crt.js:164-279) and ``handleUpdate``
(:329-385), including the documented quirks:

* Q2 — ``increment_vector_clock`` mutates the clock dict *in place*, and the
  same dict object is stored in ``meta[path].vector_clock``; a local re-put
  therefore compares a clock against itself and degrades to value-LWW
  (bullet-crt.js:56-60, 192-197).
* "no current state" discards the incoming clock and stamps a fresh
  self-clock (bullet-crt.js:171-184).

The decision table is re-derived from the survey (SURVEY.md §2 #3, §3.2),
not translated line-by-line; behavior parity is enforced by the oracle tests.

The port's own copy of ``bullet_tpu/db/crt.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ..utils.jsvalues import deep_merge_values, js_compare

VectorClock = Dict[str, int]


@dataclass
class Decision:
    defer: bool = False
    historical: bool = False
    converge: bool = True
    incoming: bool = False
    current: bool = False
    concurrent: bool = False
    vector_clock: VectorClock = field(default_factory=dict)
    reason: str = ""
    value: Any = None


def compare_vector_clocks(c1: Optional[VectorClock], c2: Optional[VectorClock]) -> int:
    """-1 if c1 < c2, +1 if c1 > c2, 0 if concurrent or equal
    (bullet-crt.js:68-95). JS tests ``!clock`` — an *empty object* is truthy
    there, so ``{}`` clocks (reachable via sync entries with empty
    vectorClock metadata) must take the comparison path, not the missing
    branch; only None means missing."""
    if c1 is None:
        return -1
    if c2 is None:
        return 1
    one_dominates = two_dominates = False
    for node in set(c1) | set(c2):
        v1, v2 = c1.get(node, 0), c2.get(node, 0)
        if v1 > v2:
            one_dominates = True
        elif v2 > v1:
            two_dominates = True
        if one_dominates and two_dominates:
            return 0
    if one_dominates:
        return 1
    if two_dominates:
        return -1
    return 0


def merge_vector_clocks(c1: Optional[VectorClock], c2: Optional[VectorClock]) -> VectorClock:
    """Elementwise max (bullet-crt.js:103-114). Always returns a new dict."""
    if not c1:
        return dict(c2 or {})
    if not c2:
        return dict(c1)
    out = dict(c1)
    for node, v in c2.items():
        out[node] = max(out.get(node, 0), v)
    return out


class BulletCRT:
    """Vector-clock conflict resolver bound to a Bullet instance."""

    def __init__(self, bullet) -> None:
        self.bullet = bullet
        self.vector_clocks: Dict[str, VectorClock] = {}
        self.compare: Callable[[Any, Any], int] = js_compare

    def set_compare(self, fn: Callable[[Any, Any], int]) -> "BulletCRT":
        self.compare = fn
        return self

    # -- clock bookkeeping (bullet-crt.js:33-60) --

    def get_vector_clock(self, key: str) -> VectorClock:
        clock = self.vector_clocks.get(key)
        if clock is None:
            clock = {self.bullet.id: 1}
            self.vector_clocks[key] = clock
        return clock

    def increment_vector_clock(self, key: str) -> VectorClock:
        # Deliberately mutates the stored dict (quirk Q2 relies on aliasing).
        clock = self.get_vector_clock(key)
        clock[self.bullet.id] = clock.get(self.bullet.id, 0) + 1
        return clock

    # -- resolution (bullet-crt.js:164-279) --

    def merge_values(self, incoming: Any, current: Any) -> Any:
        return deep_merge_values(incoming, current, self.compare)

    def resolve(
        self,
        key: str,
        incoming_clock: Optional[VectorClock],
        current_clock: Optional[VectorClock],
        incoming_value: Any,
        current_value: Any,
    ) -> Decision:
        # JS truthiness: only a missing clock (None) means "no current state";
        # an empty {} clock resolves normally (bullet-crt.js:171)
        if current_clock is None:
            clock = self.increment_vector_clock(key)
            return Decision(
                incoming=True,
                vector_clock=clock,
                reason="no current state",
                value=incoming_value,
            )

        comparison = compare_vector_clocks(incoming_clock, current_clock)
        merged_clock = merge_vector_clocks(incoming_clock, current_clock)
        self.vector_clocks[key] = merged_clock

        # identity first: quirk Q2 aliases incoming and current to ONE dict
        # on local re-puts, making the reference's JSON.stringify equality
        # (insertion-order sensitive — bullet-crt.js:188) trivially true
        # without the two dumps (hot: every local put resolves here)
        if comparison == 0 and (
            incoming_clock is current_clock
            or json.dumps(incoming_clock) == json.dumps(current_clock)
        ):
            value_cmp = self.compare(incoming_value, current_value)
            if value_cmp == 0:
                return Decision(
                    vector_clock=merged_clock,
                    reason="identical clocks and values",
                    value=current_value,
                )
            return Decision(
                incoming=value_cmp > 0,
                current=value_cmp < 0,
                vector_clock=merged_clock,
                reason="identical clocks, decided by value comparison",
                value=incoming_value if value_cmp > 0 else current_value,
            )

        if comparison > 0:
            return Decision(
                incoming=True,
                vector_clock=merged_clock,
                reason="incoming vector clock dominates",
                value=incoming_value,
            )
        if comparison < 0:
            return Decision(
                historical=True,
                current=True,
                vector_clock=merged_clock,
                reason="current vector clock dominates (incoming is historical)",
                value=current_value,
            )

        return Decision(
            concurrent=True,
            vector_clock=merged_clock,
            reason="concurrent modifications, merged objects",
            value=self.merge_values(incoming_value, current_value),
        )

    # -- write-path entry (bullet-crt.js:329-385) --

    def handle_update(
        self,
        path: str,
        incoming_data: Any,
        from_network: bool = False,
        incoming_clock: Optional[VectorClock] = None,
    ) -> dict:
        """``incoming_clock`` is the out-of-band clock channel for values
        that cannot embed ``__vectorClock`` (scalars, deletes, arrays):
        the reference wire format only attaches clocks to objects, so its
        sync apply treats every non-object entry as a LOCAL write
        (bullet-network-sync.js:551-569) — which resurrects deletes,
        regresses values, and leaves replicas permanently diverged (the
        bumped local clock then defeats every later anti-entropy pass).
        The sync protocol already ships a per-entry ``vectorClock``, so
        passing it here lets ALL entry kinds resolve through the real
        CRT decision table. See docs/conflict-resolution.md."""
        # the reference reads via the middleware-wrapped _getData
        # (bullet-crt.js:331), so get/afterGet hooks apply here too
        current_data = self.bullet._get_data(path)
        current_meta = self.bullet.meta.get(path) or {}
        current_clock = current_meta.get("vectorClock")

        data_to_store = incoming_data
        explicit_clock = incoming_clock
        if (
            from_network
            and isinstance(incoming_data, dict)
            and "__vectorClock" in incoming_data
        ):
            incoming_clock = incoming_data["__vectorClock"]
            explicit_clock = None  # embedded channel: reference-exact
            data_to_store = {
                k: v for k, v in incoming_data.items() if k != "__vectorClock"
            }
        elif incoming_clock is None:
            incoming_clock = self.increment_vector_clock(path)

        result = self.resolve(
            path, incoming_clock, current_clock, data_to_store, current_data
        )
        if explicit_clock is not None and result.reason == "no current state":
            # ADOPT the replicated entry's clock on first contact. The
            # reference's quirk (bullet-crt.js:171-173) stamps a fresh
            # self-clock and discards the wire clock, erasing causality:
            # a later remote DELETE or overwrite whose clock descends
            # from this very entry would compare CONCURRENT against the
            # self-stamp and could never dominate the state it causally
            # precedes. Only the explicit-clock channel (the fixed sync
            # apply; the reference has no such channel) adopts — every
            # reference-exact path keeps the pinned quirk (see
            # test_crt_oracle.py).
            self.vector_clocks[path] = dict(explicit_clock)
            result = Decision(
                incoming=True,
                vector_clock=dict(explicit_clock),
                reason="no current state (adopted entry clock)",
                value=result.value,
            )

        broadcast_data = result.value
        if isinstance(broadcast_data, dict):
            broadcast_data = {**broadcast_data, "__vectorClock": result.vector_clock}
        elif isinstance(broadcast_data, list):
            # the reference appends a clock-bearing element to arrays
            # (bullet-crt.js:373-374)
            broadcast_data = [*broadcast_data, {"__vectorClock": result.vector_clock}]

        return {
            "value": result.value,
            "vectorClock": result.vector_clock,
            "broadcastData": broadcast_data,
            "decision": result,
            "doUpdate": result.incoming or current_clock is None or result.concurrent,
        }

    def format_clock(self, clock: Optional[VectorClock]) -> str:
        if not clock:
            return "null"
        return ", ".join(f"{node}:{value}" for node, value in clock.items())
