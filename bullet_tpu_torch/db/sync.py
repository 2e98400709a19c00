"""Anti-entropy synchronization between peers.

Behavioral twin of bullet-js src/bullet-network-sync.js: the 6-message
protocol ``sync-request/-response/-chunk/-complete/-progress/-resume``
(:43-62), auto-sync 1 s after ``peer:connect`` (:66-70), periodic sync
(:72-76), chunking (50 entries, :18, :713-723), ``since``-timestamp
incremental filters (:602-604), timeouts (30 s initial, ≥1 s/chunk,
:108-110, :237-239) with ≤3 retries (:435-455) and missing-chunk resume
(:338-349, :478-521 — the resume handler restarts a full sync, matching the
reference), tombstone entries from ``meta[path].deleted`` (:651-661), the
per-peer state machine (:761-780), monitoring events, and ``get_sync_stats``
(:797-836).

The port's own copy of ``bullet_tpu/db/sync.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Any, Dict, List, Optional


class BulletNetworkSync:
    def __init__(self, bullet, network, options: Optional[dict] = None) -> None:
        self.bullet = bullet
        self.network = network
        opts = options or {}
        self.options = {
            "chunk_size": opts.get("chunk_size", 50),
            "sync_interval": opts.get("sync_interval", 5 * 60.0),
            "initial_sync_timeout": opts.get("initial_sync_timeout", 30.0),
            "retry_interval": opts.get("retry_interval", 5.0),
            "max_sync_attempts": opts.get("max_sync_attempts", 3),
            "progress_update_interval": opts.get("progress_update_interval", 10),
            "connect_sync_delay": opts.get("connect_sync_delay", 1.0),
            # False restores the reference's clockless application of
            # scalar/delete/array sync entries (bullet-network-sync.js:
            # 551-569) — which re-applies them as LOCAL writes, so
            # replicas resurrect deletes and regress values and can
            # never converge through anti-entropy (fixed on purpose,
            # like quirk Q1 and the since-watermark race)
            "clocked_sync_apply": opts.get("clocked_sync_apply", True),
        }
        self.sync_state: Dict[str, dict] = {}
        self.entry_errors = 0  # poisoned entries skipped (entry isolation)
        self._timers: List[threading.Timer] = []
        self._closed = False
        self._lock = threading.RLock()
        self._init_sync()

    # ----------------------------------------------------------------- wiring

    def _init_sync(self) -> None:
        """Register message handlers + connect/periodic triggers
        (bullet-network-sync.js:38-76)."""
        self.network.on("message", self._dispatch)
        self.network.on("peer:connect", self._on_peer_connect)
        self._arm_periodic()

    def _dispatch(self, peer_id: str, message: dict) -> None:
        handlers = {
            "sync-request": self._handle_sync_request,
            "sync-response": self._handle_sync_response,
            "sync-chunk": self._handle_sync_chunk,
            "sync-complete": self._handle_sync_complete,
            "sync-progress": self._handle_sync_progress,
            "sync-resume": self._handle_sync_resume,
        }
        handler = handlers.get(message.get("type"))
        if handler is not None:
            handler(peer_id, message)

    def _on_peer_connect(self, peer_id: str) -> None:
        self._after(self.options["connect_sync_delay"], self.request_sync, peer_id)

    def _arm_periodic(self) -> None:
        def tick():
            if self._closed:
                return
            self._periodic_sync()
            self._arm_periodic()

        self._after(self.options["sync_interval"], tick)

    def _after(self, delay: float, fn, *args) -> Optional[threading.Timer]:
        if self._closed:
            return None
        timer = threading.Timer(delay, fn, args=args)
        timer.daemon = True
        timer.start()
        self._timers.append(timer)
        # opportunistic GC of finished timers
        if len(self._timers) > 256:
            self._timers = [t for t in self._timers if t.is_alive()]
        return timer

    # --------------------------------------------------------------- requests

    def request_sync(self, peer_id: str, options: Optional[dict] = None) -> None:
        """Start a sync with a peer (bullet-network-sync.js:84-117)."""
        if self._closed:
            return
        options = options or {}
        state = self._peer_state(peer_id)
        with self._lock:
            if state["status"] == "in-progress":
                # the reference silently drops this (bullet-network-sync.js:
                # 88-91), leaving an explicit request unserved if it races an
                # auto-sync; queue a follow-up instead so request_sync always
                # eventually reflects current state
                state["resync_pending"] = True
                return
            request = {
                "type": "sync-request",
                "id": self._generate_id(),
                "since": state["last_sync_time_ms"] or 0,
                "partial": bool(options.get("partial")),
                "paths": list(options.get("paths", ())),
            }
            state.update(
                status="requested",
                request_id=request["id"],
                start_time=time.time(),
                attempts=state["attempts"] + 1,
                resume_tried=False,
            )
            self._cancel(state, "timeout_timer")
            state["timeout_timer"] = self._after(
                self.options["initial_sync_timeout"],
                self._handle_sync_timeout,
                peer_id,
                request["id"],
            )
        self.network.send_to_peer(peer_id, request)
        self.network.emit("sync:requested", {"peerId": peer_id, "request": request})

    requestSync = request_sync

    # -------------------------------------------------------------- responder

    def _handle_sync_request(self, peer_id: str, message: dict) -> None:
        """Serve a full/partial state transfer in chunks
        (bullet-network-sync.js:125-198).

        The response ``timestamp`` is stamped BEFORE collection and becomes
        the requester's next ``since`` watermark. The reference stamps the
        requester's own finish time (:402) — a write landing on the
        responder between collection and completion is then both missing
        from the transfer and ≤ the next since, so incremental syncs skip
        it forever (documented divergence, fixed like quirk Q1). A
        collection-start watermark on the responder's own clock re-sends
        the overlap instead (idempotent under CRT resolve)."""
        watermark_ms = int(time.time() * 1000)
        entries = self._collect_sync_data(
            message.get("since", 0), message.get("partial"), message.get("paths")
        )
        chunk_size = self.options["chunk_size"]
        chunks = [
            entries[i : i + chunk_size] for i in range(0, len(entries), chunk_size)
        ]
        request_id = message.get("id")
        self.network.send_to_peer(
            peer_id,
            {
                "type": "sync-response",
                "id": self._generate_id(),
                "requestId": request_id,
                "totalChunks": len(chunks),
                "totalEntries": len(entries),
                "timestamp": watermark_ms,
            },
        )
        for index, chunk in enumerate(chunks):
            self.network.send_to_peer(
                peer_id,
                {
                    "type": "sync-chunk",
                    "id": self._generate_id(),
                    "requestId": request_id,
                    "chunkIndex": index,
                    "totalChunks": len(chunks),
                    "entries": chunk,
                    "isLastChunk": index == len(chunks) - 1,
                },
            )
            if (
                len(chunks) > 10
                and index % self.options["progress_update_interval"] == 0
            ):
                self.network.send_to_peer(
                    peer_id,
                    {
                        "type": "sync-progress",
                        "id": self._generate_id(),
                        "requestId": request_id,
                        "chunkIndex": index,
                        "totalChunks": len(chunks),
                        "progress": int(index / len(chunks) * 100),
                    },
                )
        self.network.send_to_peer(
            peer_id,
            {
                "type": "sync-complete",
                "id": self._generate_id(),
                "requestId": request_id,
                "timestamp": int(time.time() * 1000),
            },
        )

    # -------------------------------------------------------------- requester

    def _handle_sync_response(self, peer_id: str, message: dict) -> None:
        """(bullet-network-sync.js:206-248)"""
        state = self._peer_state(peer_id)
        if state["request_id"] != message.get("requestId"):
            return
        if message.get("resuming"):
            # resume acknowledgement, not a fresh transfer: keep the
            # in-progress state and timeout machinery so the retried full
            # sync still uses the pre-failure `since` timestamp (finishing
            # here would advance it and permanently skip the missing chunks)
            return
        with self._lock:
            self._cancel(state, "timeout_timer")
            state.update(
                status="in-progress",
                total_chunks=message.get("totalChunks", 0),
                total_entries=message.get("totalEntries", 0),
                received_chunks=set(),
                last_activity=time.time(),
                # responder's collection-start watermark: the next `since`
                watermark_ms=message.get("timestamp"),
            )
            self._cancel(state, "sync_timeout_timer")
            state["sync_timeout_timer"] = self._after(
                max(30.0, state["total_chunks"] * 1.0),
                self._handle_sync_timeout,
                peer_id,
                message.get("requestId"),
            )
        self.network.emit(
            "sync:started",
            {
                "peerId": peer_id,
                "totalChunks": state["total_chunks"],
                "totalEntries": state["total_entries"],
            },
        )
        if state["total_chunks"] == 0:
            self._finish_sync(peer_id, message.get("requestId"))

    def _handle_sync_chunk(self, peer_id: str, message: dict) -> None:
        """(bullet-network-sync.js:256-292)"""
        state = self._peer_state(peer_id)
        if state["request_id"] != message.get("requestId"):
            return
        with self._lock:
            state["last_activity"] = time.time()
            state.setdefault("received_chunks", set()).add(message.get("chunkIndex"))
        self._process_sync_entries(message.get("entries", ()), peer_id)
        total = message.get("totalChunks", 0)
        # finish ONLY when every chunk arrived (bullet-network-sync.js:
        # 283-289) — an isLastChunk shortcut would falsely complete a
        # transfer with a dropped middle chunk
        if len(state["received_chunks"]) == total:
            self._finish_sync(peer_id, message.get("requestId"))
        self.network.emit(
            "sync:chunk",
            {
                "peerId": peer_id,
                "chunkIndex": message.get("chunkIndex"),
                "totalChunks": total,
                "progress": int(len(state["received_chunks"]) / total * 100)
                if total
                else 100,
            },
        )

    def _handle_sync_progress(self, peer_id: str, message: dict) -> None:
        self.network.emit(
            "sync:progress",
            {
                "peerId": peer_id,
                "chunkIndex": message.get("chunkIndex"),
                "totalChunks": message.get("totalChunks"),
                "progress": message.get("progress"),
            },
        )

    def _handle_sync_complete(self, peer_id: str, message: dict) -> None:
        """(bullet-network-sync.js:324-349)"""
        state = self._peer_state(peer_id)
        if state["request_id"] != message.get("requestId"):
            return
        if len(state.get("received_chunks", ())) < state.get("total_chunks", 0):
            missing = self._missing_chunks(state)
            self._request_missing_chunks(peer_id, message.get("requestId"), missing)
            return
        self._finish_sync(peer_id, message.get("requestId"))

    def _handle_sync_resume(self, peer_id: str, message: dict) -> None:
        """Resume = acknowledge then restart a full sync, matching the
        reference's simplification (bullet-network-sync.js:357-383)."""
        self.network.send_to_peer(
            peer_id,
            {
                "type": "sync-response",
                "id": self._generate_id(),
                "requestId": message.get("requestId"),
                "resuming": True,
                "missingChunks": len(message.get("missingChunks", ())),
            },
        )
        self._after(1.0, self.request_sync, peer_id)

    def _finish_sync(self, peer_id: str, request_id) -> None:
        """(bullet-network-sync.js:391-416). Idempotent per request: both the
        last chunk and the sync-complete message finish a sync; the second
        call must not clobber the stored watermark with local finish time."""
        state = self._peer_state(peer_id)
        with self._lock:
            if state["status"] == "complete" and state.get("request_id") == request_id:
                return
            self._cancel(state, "sync_timeout_timer")
            self._cancel(state, "timeout_timer")
            state["status"] = "complete"
            state["last_sync_time"] = time.time()
            # prefer the responder's collection-start watermark (see
            # _handle_sync_request); fall back to local finish time for
            # peers that don't send one
            state["last_sync_time_ms"] = (
                state.pop("watermark_ms", None)
                or int(state["last_sync_time"] * 1000)
            )
            state["last_sync_duration"] = state["last_sync_time"] - (
                state.get("start_time") or state["last_sync_time"]
            )
            state["attempts"] = 0
            state["resume_tried"] = False
            resync = state.pop("resync_pending", False)
        if resync and not self._closed:
            self._after(0.05, self.request_sync, peer_id)
        self.network.emit(
            "sync:complete",
            {
                "peerId": peer_id,
                "duration": state["last_sync_duration"],
                "entriesProcessed": state.get("total_entries", 0),
            },
        )

    # --------------------------------------------------------- failure paths

    def _handle_sync_timeout(self, peer_id: str, request_id) -> None:
        """Retry / resume / fail (bullet-network-sync.js:424-469)."""
        state = self._peer_state(peer_id)
        if state["request_id"] != request_id or self._closed:
            return
        if state["status"] == "complete":
            return
        if state["attempts"] < self.options["max_sync_attempts"]:
            with self._lock:
                try_resume = (
                    state["status"] == "in-progress"
                    and bool(state.get("received_chunks"))
                    and not state.get("resume_tried")
                )
                if try_resume:
                    # a resume attempt must count toward max_sync_attempts,
                    # and only one is tried per request — the responder's
                    # resume handling restarts a sync in the REVERSE
                    # direction (reference simplification,
                    # bullet-network-sync.js:357-383), so it never re-sends
                    # the missing chunks; without this cap the requester
                    # would loop resume requests forever, wedged
                    # 'in-progress' and deaf to new sync requests
                    state["attempts"] += 1
                    state["resume_tried"] = True
            if try_resume:
                self._request_missing_chunks(
                    peer_id, request_id, self._missing_chunks(state)
                )
            else:
                state["status"] = "initial"
                self._after(self.options["retry_interval"], self.request_sync, peer_id)
        else:
            state["status"] = "failed"
            self.network.emit(
                "sync:failed",
                {"peerId": peer_id, "attempts": state["attempts"], "reason": "timeout"},
            )

    def _request_missing_chunks(self, peer_id: str, request_id, missing) -> None:
        """(bullet-network-sync.js:478-504)"""
        self.network.send_to_peer(
            peer_id,
            {
                "type": "sync-resume",
                "id": self._generate_id(),
                "requestId": request_id,
                "missingChunks": list(missing),
            },
        )
        state = self._peer_state(peer_id)
        with self._lock:
            state["last_activity"] = time.time()
            self._cancel(state, "sync_timeout_timer")
            state["sync_timeout_timer"] = self._after(
                max(self.options["initial_sync_timeout"] / 3.0,
                    len(missing) * 1.0),
                self._handle_sync_timeout,
                peer_id,
                request_id,
            )
        self.network.emit(
            "sync:resume-requested",
            {"peerId": peer_id, "missingChunks": len(missing)},
        )

    @staticmethod
    def _missing_chunks(state: dict) -> List[int]:
        total = state.get("total_chunks") or 0
        received = state.get("received_chunks") or set()
        return [i for i in range(total) if i not in received]

    # ------------------------------------------------------------ data plane

    def _process_sync_entries(self, entries, peer_id: str) -> None:
        """Re-apply entries through the CRT write path
        (bullet-network-sync.js:551-569).

        Every entry resolves under its OWN vector clock: the wire already
        carries ``vectorClock`` per entry, but the reference only threads
        it through for object values — scalar, delete, and array entries
        re-apply as LOCAL writes there, which resurrects deletes,
        regresses values, and (because the local clock increments) makes
        the damage permanent: no later sync can out-dominate it, so
        replicas that disagree on a scalar leaf NEVER converge. Fixed on
        purpose (``clocked_sync_apply: False`` restores the reference
        behavior), same policy as quirk Q1 and the since-watermark race."""
        clocked = self.options["clocked_sync_apply"]
        for entry in entries:
            path = entry.get("path")
            data = entry.get("data")
            # {} clocks fall back to the local-write path: an explicit
            # empty clock would lose every comparison and the entry
            # (which DID exist on the responder) would never apply
            clock = (entry.get("vectorClock") or None) if clocked else None
            if clock is not None and self._scalar_ancestor_blocks(path):
                # Pre-resolve the subtree-vs-scalar collision BY CLOCK
                # before set_data's read can touch the store: a FALSY
                # scalar ancestor (None/0/false/"") never raises the Q3
                # TypeError — the autovivifying read would silently
                # replace it with {} and the leaf would win REGARDLESS
                # of clocks, while the scalar side of the same conflict
                # resolves by clock. That asymmetry is a live resolution
                # CYCLE (scalar beats dict by value at the root; leaf
                # destroys scalar by vivification underneath), which
                # either livelocks anti-entropy or — once watermarks
                # pass both sides — freezes a permanent split (found by
                # the system chaos soak).
                if not self._resolve_scalar_ancestor(path, clock):
                    continue  # scalar ancestor won; re-offer bump done
            try:
                if entry.get("deleted"):
                    self.bullet.set_data(
                        path, None, broadcast=False, incoming_clock=clock
                    )
                else:
                    if isinstance(data, dict):
                        data = {
                            **data,
                            "__fromNetwork": True,
                            "__vectorClock": entry.get("vectorClock", {}),
                        }
                        clock = None  # the embedded clock is the channel
                    elif isinstance(data, list):
                        from .network import strip_array_clock

                        data, embedded = strip_array_clock(data)
                        if clocked and embedded:
                            clock = embedded
                    self.bullet.set_data(
                        path, data, broadcast=False, incoming_clock=clock
                    )
            except TypeError as err:
                # A child leaf arrived where a local ANCESTOR is a scalar
                # (the Q3 strict-mode "Cannot create property" TypeError).
                # Resolve the subtree-vs-scalar conflict at the collision
                # point by CLOCK — symmetric with the dict side, where
                # the scalar entry resolves against the dict through the
                # normal decision table — so both replicas land on the
                # same winner in every clock relation (see
                # docs/conflict-resolution.md). Without clocks, fall back
                # to counting the entry as poisoned (entry isolation).
                if clock is not None and self._resolve_scalar_ancestor(
                    path, clock
                ):
                    try:
                        self.bullet.set_data(
                            path,
                            None if entry.get("deleted") else data,
                            broadcast=False,
                            incoming_clock=clock,
                        )
                        continue
                    except Exception as retry_err:  # noqa: BLE001
                        err = retry_err
                elif clock is not None:
                    continue  # scalar ancestor won; re-offer bump done
                self.entry_errors += 1
                self.network.emit(
                    "sync:entry-error",
                    {"peerId": peer_id, "path": path, "error": err},
                )
            except Exception as err:  # noqa: BLE001 - entry isolation
                # One poisoned entry must not abort the chunk: the
                # reference's unguarded loop (bullet-network-sync.js:
                # 551-569) loses EVERY later entry in the chunk while
                # the watermark still advances — silent permanent data
                # loss for unrelated paths. Count + surface instead.
                self.entry_errors += 1
                self.network.emit(
                    "sync:entry-error",
                    {"peerId": peer_id, "path": path, "error": err},
                )

    def _collect_sync_data(self, since, partial, paths) -> List[dict]:
        if partial and paths:
            return self._collect_partial_sync_data(paths, since or 0)
        return self._collect_full_sync_data(since or 0)

    def _scalar_ancestor_blocks(self, path: str) -> bool:
        """True iff some STRICT ancestor of ``path`` holds a present,
        non-dict value (scalar/None/array) in the store — the collision
        _resolve_scalar_ancestor clock-resolves. Missing keys don't
        block (set_data creates the chain). Non-destructive: no reads
        through the vivifying walk. Advisory (the lock is taken by the
        resolver, which re-walks); a racing write falls back to the
        TypeError backstop."""
        from ..utils.paths import split_path

        parts = split_path(path or "")
        if len(parts) < 2:
            return False
        node = self.bullet.store
        for part in parts[:-1]:
            if not isinstance(node, dict) or part not in node:
                return False
            node = node[part]
            if not isinstance(node, dict):
                return True
        return False

    def _resolve_scalar_ancestor(self, path: str, clock: dict) -> bool:
        """Clock-resolve a child-leaf sync entry that collided with a
        non-dict local ancestor. True → the entry's clock DOMINATES the
        blocking ancestor's: the scalar is causally superseded, so it is
        cleared to ``{}`` (clock merged, the subtree write owns the path
        now) and the caller retries the entry. False → the scalar stays
        (its clock dominates or is concurrent — the same relation under
        which the dict side keeps/adopts the scalar through the normal
        decision table, so both replicas pick the SAME winner); its
        lastModified is touched so the scalar is re-offered to the
        entry's (stale or conflicting) sender."""
        from .crt import compare_vector_clocks, merge_vector_clocks
        from ..utils.paths import split_path

        bullet = self.bullet
        with bullet._lock:
            node = bullet.store
            parts = split_path(path)
            anc_parts = []
            for part in parts[:-1]:
                anc_parts.append(part)
                # key-PRESENCE check, not truthiness: a stored None IS a
                # scalar ancestor that must clock-resolve (treating it
                # as "vanished" would retry set_data, whose vivifying
                # read destroys the None without any clock comparison)
                if not isinstance(node, dict) or part not in node:
                    return True  # vanished meanwhile; just retry
                node = node[part]
                if not isinstance(node, dict):
                    anc_path = "/".join(anc_parts)
                    anc_meta = bullet.meta.get(anc_path) or {}
                    anc_clock = anc_meta.get("vectorClock")
                    cmp0 = (
                        1 if anc_clock is None
                        else compare_vector_clocks(clock, anc_clock)
                    )
                    if cmp0 > 0 or (
                        cmp0 == 0 and self._subtree_beats_scalar(node)
                    ):
                        parent = bullet.store
                        for p in anc_parts[:-1]:
                            parent = parent[p]
                        parent[anc_parts[-1]] = {}
                        bullet.meta[anc_path] = {
                            **anc_meta,
                            "vectorClock": merge_vector_clocks(
                                clock, anc_clock
                            ),
                            "lastModified": int(time.time() * 1000),
                        }
                        return True
                    bullet.meta[anc_path] = {
                        **anc_meta,
                        "lastModified": int(time.time() * 1000),
                    }
                    return False
            return True  # no blocking ancestor found; retry as-is

    def _subtree_beats_scalar(self, scalar_value) -> bool:
        """Clock-TIE (equal or concurrent) subtree-vs-scalar tie-break,
        symmetric with the dict side of the same conflict: there, the
        incoming SCALAR resolves against the local dict through
        ``compare(scalar, dict)`` (crt.resolve's identical-clock branch /
        deep_merge_values' comparator-LWW), so this side must adopt the
        subtree exactly when that side keeps its dict. That mirroring is
        only sound when the comparator is ANTISYMMETRIC on the cross-type
        pair — ``total_compare`` is (dict/opaque outranks every scalar);
        the reference's ``js_compare`` is NOT (incomparable ⇒ "incoming
        wins" on BOTH sides, bullet-crt.js:11-15), and under it the dict
        side ADOPTS the scalar, so the scalar must stay here for both
        replicas to land on the scalar. Probe antisymmetry instead of
        special-casing comparator identity so custom comparators get the
        convergent behavior iff they earn it. The ``{}`` stand-in gives
        the same verdict as the real subtree for any type-tag-first order
        (content only breaks opaque-vs-opaque ties; the blocking ancestor
        is a non-dict by construction, and for the one opaque non-dict —
        an array — canonical JSON puts every ``[...]`` below every
        ``{...}``, so the stand-in's verdict still matches the real
        subtree's). Found by the wire-fuzz chaos soak:
        identical-clock scalar-vs-dict conflicts under ``compare:
        "total"`` froze one replica on the scalar while the dict side
        kept the dict."""
        compare = self.bullet.crt.compare
        try:
            fwd = compare({}, scalar_value)
            rev = compare(scalar_value, {})
        except Exception:  # noqa: BLE001 - custom comparator errors
            return False
        return fwd > 0 and rev < 0

    def _leaf_meta(self, path: str) -> dict:
        """A leaf's meta, falling back to the NEAREST ANCESTOR with meta:
        leaves materialized by a subtree put carry no per-leaf meta — the
        clock of the write that created them lives at the put path. The
        reference ships such leaves with vectorClock {} (so they re-apply
        as local writes); the ancestor clock is their true write clock
        and lets the receiver resolve them through the CRT. Requires
        clock-less requesters (real bullet-js) to behave exactly as
        before — they ignore entry clocks for non-objects anyway."""
        meta = self.bullet.meta.get(path)
        if meta:
            return meta
        from ..utils.paths import ancestors

        for parent in ancestors(path):
            meta = self.bullet.meta.get(parent)
            if meta:
                return meta
        return {}

    def _collect_full_sync_data(self, since: int) -> List[dict]:
        """Recursive store traversal emitting leaf entries
        (bullet-network-sync.js:592-664).

        The ``since`` filter uses an ANCESTOR-AWARE effective
        lastModified: a leaf is re-offered when its own meta OR any
        ancestor's meta is fresh. The re-offer touches (core.py's
        loser-touch, _resolve_scalar_ancestor) land on the path where
        the losing entry arrived — which, when the local winner is a
        SUBTREE, is the subtree ROOT, not a store leaf. Filtering on
        the leaf's own lastModified alone freezes exactly that case
        into a permanent split: the winning child leaves keep their old
        stamps, fall behind every watermark, and are never offered
        again, while the remote scalar keeps losing here — both
        replicas stable, forever different (found by the system chaos
        soak: 4 peers holding a clock-dominated scalar null vs 2
        holding the dominant dict, 300 anti-entropy rounds no-op)."""
        entries: List[dict] = []

        def emit_leaf(path: str, value: Any, anc_lm: int = 0) -> None:
            meta = self._leaf_meta(path)
            last_modified = meta.get("lastModified", 0)
            effective = max(last_modified or 0, anc_lm)
            if since > 0 and effective and effective < since:
                return
            entries.append(
                {
                    "path": path,
                    "data": value,
                    "vectorClock": meta.get("vectorClock", {}),
                    "lastModified": last_modified,
                    "deleted": False,
                }
            )

        meta_map = self.bullet.meta

        def traverse(obj: Any, prefix: str, anc_lm: int = 0) -> bool:
            """Emit entries under ``prefix``; returns whether the subtree
            contains ANY leaf (independent of the since filter)."""
            if prefix:
                own = meta_map.get(prefix)
                if own:
                    anc_lm = max(anc_lm, own.get("lastModified", 0) or 0)
            if not isinstance(obj, dict):
                emit_leaf(prefix, obj, anc_lm)
                return True
            has_leaf = False
            for key, value in obj.items():
                path = f"{prefix}/{key}" if prefix else key
                if isinstance(value, dict):
                    has_leaf |= traverse(value, path, anc_lm)
                else:
                    emit_leaf(path, value, anc_lm)
                    has_leaf = True
            if not has_leaf and prefix and meta_map.get(prefix):
                # LEAFLESS subtree with its own clock (Q3 vivification
                # and _resolve_scalar_ancestor both produce these, e.g.
                # {} or {"n": {}}): no leaf exists to carry that clock,
                # so a dominant leafless subtree would be a sync BLACK
                # HOLE — remote dominated values keep losing into it
                # while it can never propagate (found by the chaos soak:
                # store {} with clock {A:11} vs a stable remote null
                # with {A:10}, forever). Ship the empty object itself;
                # the receiver resolves it through the CRT like any
                # dict put. Guarded on has_leaf (not the since filter)
                # so old-but-real leaves are never misrepresented as {}.
                # The reference's traverse skips these (same latent
                # divergence).
                emit_leaf(prefix, {}, anc_lm)
            return has_leaf

        lock = getattr(self.bullet, "_lock", None)
        if lock is not None:
            with lock:
                traverse(self.bullet.store, "")
                meta_items = list(self.bullet.meta.items())
        else:
            traverse(self.bullet.store, "")
            meta_items = list(self.bullet.meta.items())

        for path, meta in meta_items:
            if meta.get("deleted") and (not since or meta.get("lastModified", 0) >= since):
                entries.append(
                    {
                        "path": path,
                        "data": None,
                        "vectorClock": meta.get("vectorClock", {}),
                        "lastModified": meta.get("lastModified", 0),
                        "deleted": True,
                    }
                )
        return entries

    def _collect_partial_sync_data(self, paths, since: int) -> List[dict]:
        """(bullet-network-sync.js:673-705); the ``since`` filter is
        ancestor-aware like _collect_full_sync_data's (a re-offer touch
        at a subtree root must lift the subtree)."""
        from ..utils.paths import ancestors

        entries = []
        for path in paths:
            data = self.bullet._get_data(path)
            meta = self._leaf_meta(path)
            last_modified = meta.get("lastModified", 0)
            effective = last_modified or 0
            for parent in ancestors(path):
                pm = self.bullet.meta.get(parent)
                if pm:
                    effective = max(effective, pm.get("lastModified", 0) or 0)
            if since > 0 and effective and effective < since:
                continue
            entries.append(
                {
                    "path": path,
                    "data": data,
                    "vectorClock": meta.get("vectorClock", {}),
                    "lastModified": last_modified,
                    "deleted": bool(data is None and meta.get("deleted")),
                }
            )
        return entries

    # -------------------------------------------------------------- periodic

    def _periodic_sync(self) -> None:
        """(bullet-network-sync.js:729-753)"""
        now = time.time()
        for peer_id in list(self.network.peers):
            state = self._peer_state(peer_id)
            if state["status"] == "in-progress":
                continue
            if (
                state["last_sync_time"]
                and now - state["last_sync_time"] < self.options["sync_interval"]
            ):
                continue
            if (
                state["status"] == "failed"
                and state["attempts"] >= self.options["max_sync_attempts"]
            ):
                continue
            self.request_sync(peer_id)

    # -------------------------------------------------------------- state/api

    def _peer_state(self, peer_id: str) -> dict:
        """(bullet-network-sync.js:761-780)"""
        with self._lock:
            if peer_id not in self.sync_state:
                self.sync_state[peer_id] = {
                    "status": "initial",
                    "last_sync_time": 0.0,
                    "last_sync_time_ms": 0,
                    "last_sync_duration": 0.0,
                    "attempts": 0,
                    "request_id": None,
                    "total_chunks": 0,
                    "total_entries": 0,
                    "received_chunks": set(),
                    "timeout_timer": None,
                    "sync_timeout_timer": None,
                    "start_time": 0.0,
                    "last_activity": 0.0,
                }
            return self.sync_state[peer_id]

    @staticmethod
    def _cancel(state: dict, key: str) -> None:
        timer = state.get(key)
        if timer is not None:
            timer.cancel()
            state[key] = None

    def _generate_id(self) -> str:
        return f"sync-{int(time.time() * 1000)}-{secrets.token_hex(8)}"

    def get_sync_stats(self) -> dict:
        """(bullet-network-sync.js:797-836)"""
        stats = {
            "peers": {},
            "totalSyncs": 0,
            "activeSyncs": 0,
            "failedSyncs": 0,
            "lastSyncTime": 0.0,
            "entryErrors": self.entry_errors,
        }
        for peer_id, state in self.sync_state.items():
            total = state.get("total_chunks") or 0
            stats["peers"][peer_id] = {
                "status": state["status"],
                "lastSyncTime": state["last_sync_time"],
                "lastSyncDuration": state["last_sync_duration"],
                "attempts": state["attempts"],
                "progress": int(len(state.get("received_chunks", ())) / total * 100)
                if state["status"] == "in-progress" and total
                else 0,
            }
            if state["status"] == "in-progress":
                stats["activeSyncs"] += 1
            if state["status"] == "failed":
                stats["failedSyncs"] += 1
            if state["last_sync_time"] > stats["lastSyncTime"]:
                stats["lastSyncTime"] = state["last_sync_time"]
            if state["last_sync_time"] > 0:
                stats["totalSyncs"] += 1
        return stats

    getSyncStats = get_sync_stats

    def reset_peer_sync(self, peer_id: str) -> None:
        """(bullet-network-sync.js:843-861)"""
        state = self._peer_state(peer_id)
        with self._lock:
            self._cancel(state, "timeout_timer")
            self._cancel(state, "sync_timeout_timer")
            state["status"] = "initial"
            state["attempts"] = 0
            state["request_id"] = None

    resetPeerSync = reset_peer_sync

    def close(self) -> None:
        """(bullet-network-sync.js:867-881)"""
        self._closed = True
        for state in self.sync_state.values():
            self._cancel(state, "timeout_timer")
            self._cancel(state, "sync_timeout_timer")
        for timer in self._timers:
            timer.cancel()
        self.sync_state.clear()
