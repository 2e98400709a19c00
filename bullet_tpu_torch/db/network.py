"""Peer-to-peer networking: TTL-bounded flood over a TCP/NDJSON transport.

Behavioral twin of bullet-js src/bullet-network.js with WebSockets
replaced by newline-delimited JSON over TCP (the reference's only hard
dependency was the ``ws`` package; the protocol semantics are what matter):

* handshake / handshake-response carrying the peer id (:159-199, :261-269)
* self-connection rejection (:80-84, :186-190) and duplicate-connection
  arbitration preferring existing outbound links (:96-115)
* auth hooks: ``connection_handler`` (:86-92) and
  ``prepare_connection_headers`` (:148-153)
* message dedup via a processed-id set pruned 10% past ``message_cache_size``
  (:289-302), TTL-bounded flood relay with ``max_ttl`` (:14, :378-396)
* ``broadcast`` (:404-418), ``send_to_peer`` (:355-370), reconnect every 5 s
  (:204-217, :253-258), and the sync manager hook (:26-28)

Peer URLs accept ``tcp://host:port`` or plain ``host:port`` (NDJSON framing,
the default between bullet_tpu_torch nodes) and ``ws://host:port`` (real RFC 6455
WebSocket framing for wire interop with actual bullet-js peers: JSON text
frames, peer id in the ``x-peer-id`` upgrade header — see db/ws.py). The
server auto-detects the framing per inbound connection, so one port serves
both kinds of peers.

The port's own copy of ``bullet_tpu/db/network.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import queue
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .sync import BulletNetworkSync


class EventEmitter:
    def __init__(self) -> None:
        self._event_listeners: Dict[str, List[Callable]] = {}

    def on(self, event: str, listener: Callable) -> None:
        self._event_listeners.setdefault(event, []).append(listener)

    def emit(self, event: str, *args) -> None:
        for listener in list(self._event_listeners.get(event, ())):
            try:
                listener(*args)
            except Exception:  # noqa: BLE001 - listener isolation
                pass


def strip_array_clock(data):
    """Array wire payloads carry a trailing ``{"__vectorClock": ...}`` marker
    element (bullet-crt.js:373-374). The reference never strips it on receive
    and stores it as data — a corruption bug we fix (documented divergence:
    PARITY.md): strip the marker so replicas hold the real array."""
    if (
        isinstance(data, list)
        and data
        and isinstance(data[-1], dict)
        and set(data[-1].keys()) == {"__vectorClock"}
    ):
        return data[:-1], data[-1]["__vectorClock"]
    return data, None


def parse_peer_url(url: str):
    """(host, port, framing): ws:// URLs use WebSocket framing, wss:// adds
    TLS on the dialer side ("wss" framing)."""
    framing = "ndjson"
    for prefix in ("tcp://", "ws://", "wss://", "http://"):
        if url.startswith(prefix):
            if prefix == "ws://":
                framing = "ws"
            elif prefix == "wss://":
                framing = "wss"
            url = url[len(prefix) :]
            break
    host, _, port = url.partition(":")
    return host or "127.0.0.1", int(port or 8765), framing


class _PeerConnection:
    """One live link: socket + outbound writer thread + reader thread.

    Sends are queued and drained by a dedicated writer thread so that a peer
    with a full TCP buffer can never block a caller — callers frequently hold
    ``bullet._lock`` (set_data broadcasts, sync chunk emission), and a
    blocking sendall there deadlocks two peers writing heavily at each other
    (the async Node reference cannot hit this). Per-connection FIFO order is
    preserved by the single writer."""

    # A peer that stops reading fills its TCP buffer and stalls the writer
    # thread; without a cap the outbox would then grow without bound (the
    # deadlock the writer thread fixed must not become a memory leak).
    # At the cap the connection is declared dead and closed — the
    # reconnect/anti-entropy machinery recovers state when the peer heals,
    # exactly as it does for any other connection loss.
    MAX_OUTBOX = 10000  # frames (~the network-layer dedup cache size)

    def __init__(self, sock: socket.socket, peer_id: str, outbound: bool, url=None,
                 framing: str = "ndjson"):
        self.socket = sock
        self.peer_id = peer_id
        self.outbound = outbound
        self.url = url
        self.framing = framing  # "ndjson" | "ws-server" | "ws-client"
        self.connected_at = time.time()
        self.open = True
        # bounded: the cap is enforced atomically by the queue itself
        # (a qsize() check-then-put would race between the app thread's
        # broadcasts and the reader thread's ws control replies)
        self._outbox: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self.MAX_OUTBOX
        )
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True, name=f"bullet-write-{peer_id[:8]}"
        )
        self._writer.start()

    def send_raw(self, data: bytes) -> None:
        """Enqueue pre-framed bytes (ws control replies from the reader)."""
        if self.open:
            self._enqueue(data)

    def _enqueue(self, data: bytes) -> None:
        try:
            self._outbox.put_nowait(data)
        except queue.Full:
            # stalled reader on the far side: drop the link, don't leak
            self.close()

    def send(self, message: dict) -> bool:
        if not self.open:
            return False
        text = json.dumps(message, default=str)
        if self.framing == "ndjson":
            data = (text + "\n").encode("utf-8")
        else:
            from .ws import OP_TEXT, encode_frame

            data = encode_frame(
                text.encode("utf-8"), OP_TEXT, mask=self.framing == "ws-client"
            )
        self._enqueue(data)
        return self.open

    def _write_loop(self) -> None:
        while True:
            data = self._outbox.get()
            if data is None:
                return
            try:
                self.socket.sendall(data)
            except OSError:
                self.open = False
                return

    def close(self) -> None:
        self.open = False
        try:
            # wake the writer; on a full outbox the socket shutdown below
            # unblocks it anyway (sendall raises, loop exits)
            self._outbox.put_nowait(None)
        except queue.Full:
            pass
        try:
            self.socket.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.socket.close()
        except OSError:
            pass
        # Deterministic teardown: the writer must not outlive the link. The
        # sentinel/shutdown above unblocks it from get()/sendall(); join
        # unless close() is running ON the writer (send failure path).
        if threading.current_thread() is not self._writer:
            self._writer.join(timeout=5.0)


class BulletNetwork(EventEmitter):
    def __init__(self, bullet, options: Optional[dict] = None) -> None:
        super().__init__()
        self.bullet = bullet
        opts = options or {}
        self.options = {
            "port": opts.get("port", 8765),
            "host": opts.get("host", "0.0.0.0"),
            "peers": list(opts.get("peers", ())),
            "max_ttl": opts.get("max_ttl", opts.get("maxTTL", 32)),
            "message_cache_size": opts.get(
                "message_cache_size", opts.get("messageCacheSize", 10000)
            ),
            "enable_sync": opts.get("enable_sync", opts.get("enableSync", True)),
            "connection_handler": opts.get(
                "connection_handler", opts.get("connectionHandler")
            ),
            "prepare_connection_headers": opts.get(
                "prepare_connection_headers", opts.get("prepareConnectionHeaders")
            ),
            "server": opts.get("server", True),
            "reconnect_interval": opts.get("reconnect_interval", 5.0),
            # False restores the reference's clockless scalar/array flood
            # apply (arrival-order resolution; see _handle_put)
            "clocked_puts": opts.get("clocked_puts", True),
            "ssl_context": opts.get("ssl_context"),
            "sync_options": {
                k: v
                for k, v in opts.items()
                if k
                in (
                    "chunk_size",
                    "sync_interval",
                    "initial_sync_timeout",
                    "retry_interval",
                    "max_sync_attempts",
                    "progress_update_interval",
                    "connect_sync_delay",
                    "clocked_sync_apply",
                )
            },
        }

        self.local_peer_id = bullet.id
        self.peers: Dict[str, _PeerConnection] = {}
        self.server_socket: Optional[socket.socket] = None
        self.port: Optional[int] = None  # actual bound port
        self.processed_messages: "dict[str, None]" = {}  # insertion-ordered set
        self._closed = False
        self._threads: List[threading.Thread] = []
        # sockets mid-handshake/dial (no _PeerConnection yet): close() shuts
        # them down so their threads wake instead of riding out timeouts
        self._pending_socks: set = set()
        self._reconnect_timers: List[threading.Timer] = []
        self._lock = threading.RLock()

        self.sync = (
            BulletNetworkSync(bullet, self, self.options["sync_options"])
            if self.options["enable_sync"]
            else None
        )

        if self.options["server"] is not False:
            self._start_listening()
        self._connect_to_peers()

    # ------------------------------------------------------------- lifecycle

    def _start_listening(self) -> None:
        try:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.options["host"], self.options["port"]))
            srv.listen(64)
            self.server_socket = srv
            self.port = srv.getsockname()[1]
            t = threading.Thread(
                target=self._accept_loop, daemon=True,
                name=f"bullet-accept-{self.local_peer_id[:8]}",
            )
            t.start()
            self._threads.append(t)
        except OSError as err:
            self.emit("error", err)

    def _accept_loop(self) -> None:
        while not self._closed and self.server_socket is not None:
            try:
                sock, _addr = self.server_socket.accept()
            except OSError:
                return
            if self._closed:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            t = threading.Thread(
                target=self._handle_incoming_connection, args=(sock,),
                daemon=True, name=f"bullet-handshake-{self.local_peer_id[:8]}",
            )
            t.start()
            self._threads.append(t)

    def _handle_incoming_connection(self, sock: socket.socket) -> None:
        """Wait for the handshake, apply auth/duplicate policies
        (bullet-network.js:71-118). Framing auto-detects: an HTTP ``GET``
        first line is a WebSocket upgrade from a real bullet-js peer (peer id
        in the x-peer-id header, bullet-network.js:72); anything else is the
        NDJSON handshake message."""
        sock.settimeout(10.0)
        with self._lock:
            self._pending_socks.add(sock)
        try:
            self._handshake_incoming(sock)
        finally:
            with self._lock:
                self._pending_socks.discard(sock)

    def _handshake_incoming(self, sock: socket.socket) -> None:
        reader = sock.makefile("rb")
        try:
            line = reader.readline()
        except OSError:
            sock.close()
            return
        framing = "ndjson"
        if line.startswith(b"GET "):
            from . import ws

            try:
                http_headers = ws.server_handshake(reader, sock, line)
            except OSError:
                sock.close()
                return
            if http_headers is None:
                sock.close()
                return
            remote_peer_id = http_headers.get("x-peer-id")
            headers = http_headers
            framing = "ws-server"
        else:
            try:
                message = json.loads(line)
            except ValueError:
                sock.close()
                return
            if message.get("type") != "handshake":
                sock.close()
                return
            remote_peer_id = message.get("peerId")
            headers = message.get("headers") or {}
        if not remote_peer_id or remote_peer_id == self.local_peer_id:
            sock.close()
            return
        handler = self.options["connection_handler"]
        if callable(handler) and handler(headers, sock, remote_peer_id) is False:
            sock.close()
            return
        with self._lock:
            existing = self.peers.get(remote_peer_id)
            if existing is not None and existing.open:
                if existing.outbound:
                    sock.close()
                    return
                existing.close()
        sock.settimeout(None)
        self._setup_peer_connection(
            sock, reader, remote_peer_id, outbound=False, framing=framing
        )

    def _connect_to_peers(self) -> None:
        # dial in the background: a down peer must not block Bullet() startup
        # for its whole connect timeout (the reference dials asynchronously)
        for peer_url in self.options["peers"]:
            t = threading.Thread(
                target=self._connect_to_peer, args=(peer_url,), daemon=True,
                name=f"bullet-dial-{self.local_peer_id[:8]}",
            )
            t.start()
            self._threads.append(t)

    def _connect_to_peer(self, peer_url: str) -> None:
        """Dial a peer, send the handshake, await the response
        (bullet-network.js:139-218)."""
        if self._closed:
            return
        sock = None
        try:
            host, port, framing = parse_peer_url(peer_url)
            sock = socket.create_connection((host, port), timeout=10.0)
            with self._lock:
                if self._closed:
                    sock.close()
                    return
                self._pending_socks.add(sock)
            if framing == "wss":
                # TLS-wrapped WebSocket (a plain socket to a TLS listener
                # would otherwise fail silently into the reconnect loop).
                # ``ssl_context`` option overrides cert handling (tests /
                # self-signed deployments).
                import ssl

                ctx = self.options.get("ssl_context") or ssl.create_default_context()
                with self._lock:
                    self._pending_socks.discard(sock)
                sock = ctx.wrap_socket(sock, server_hostname=host)
                with self._lock:
                    self._pending_socks.add(sock)
                framing = "ws"
            headers = {"x-peer-id": self.local_peer_id}
            prepare = self.options["prepare_connection_headers"]
            if callable(prepare):
                custom = prepare(peer_url)
                if isinstance(custom, dict):
                    headers.update(custom)
            reader = sock.makefile("rb")
            if framing == "ws":
                # real WebSocket dial, exactly like a bullet-js client:
                # upgrade with x-peer-id header, send a handshake message,
                # learn the remote id from handshake(-response)
                # (bullet-network.js:139-218)
                from . import ws

                if not ws.client_handshake(sock, reader, host, port, headers):
                    sock.close()
                    raise ConnectionError("websocket upgrade failed")
                conn_framing = "ws-client"

                def send_raw(msg: dict) -> None:
                    sock.sendall(
                        ws.encode_frame(
                            json.dumps(msg).encode("utf-8"), ws.OP_TEXT, mask=True
                        )
                    )

                def recv_msg():
                    text = ws.read_message(reader, sock, client_side=True)
                    return None if text is None else json.loads(text)

            else:
                conn_framing = "ndjson"

                def send_raw(msg: dict) -> None:
                    sock.sendall((json.dumps(msg) + "\n").encode("utf-8"))

                def recv_msg():
                    line = reader.readline()
                    return json.loads(line) if line else None

            send_raw(
                {
                    "type": "handshake",
                    "id": self._generate_id(),
                    "peerId": self.local_peer_id,
                    "headers": headers,
                }
            )
            message = recv_msg()
            while message is not None and message.get("type") not in (
                "handshake", "handshake-response",
            ):
                message = recv_msg()
            if message is None:
                sock.close()
                raise ConnectionError("no handshake response")
            remote_peer_id = message.get("peerId")
            if not remote_peer_id or remote_peer_id == self.local_peer_id:
                sock.close()
                return
            sock.settimeout(None)
            self._setup_peer_connection(
                sock, reader, remote_peer_id, True, peer_url, framing=conn_framing
            )
        except (OSError, ValueError, ConnectionError) as err:
            self.emit("error", err)
            self._schedule_reconnect(peer_url)
        finally:
            if sock is not None:
                with self._lock:
                    self._pending_socks.discard(sock)

    def _schedule_reconnect(self, peer_url: str) -> None:
        if self._closed:
            return
        timer = threading.Timer(
            self.options["reconnect_interval"], self._connect_to_peer, args=(peer_url,)
        )
        timer.daemon = True
        timer.start()
        self._reconnect_timers.append(timer)
        # opportunistic GC: a permanently-down peer schedules one timer per
        # interval forever; without pruning the list grows unboundedly
        if len(self._reconnect_timers) > 64:
            self._reconnect_timers = [
                t for t in self._reconnect_timers if t.is_alive()
            ]

    def _setup_peer_connection(
        self, sock, reader, peer_id: str, outbound: bool, peer_url=None,
        framing: str = "ndjson",
    ) -> None:
        """Register the link, start its reader, emit peer:connect
        (bullet-network.js:228-278)."""
        conn = _PeerConnection(sock, peer_id, outbound, peer_url, framing=framing)
        with self._lock:
            self.peers[peer_id] = conn
        if not outbound:
            conn.send(
                {
                    "type": "handshake-response",
                    "id": self._generate_id(),
                    "peerId": self.local_peer_id,
                }
            )
        t = threading.Thread(
            target=self._read_loop, args=(conn, reader), daemon=True,
            name=f"bullet-read-{self.local_peer_id[:8]}",
        )
        t.start()
        self._threads.append(t)
        self.emit("peer:connect", peer_id)

    def _read_loop(self, conn: _PeerConnection, reader) -> None:
        from . import ws

        while conn.open and not self._closed:
            try:
                if conn.framing == "ndjson":
                    raw = reader.readline()
                    if not raw:  # readline() returns "" only at EOF
                        break
                else:
                    raw = ws.read_message(
                        reader, conn.socket,
                        client_side=conn.framing == "ws-client",
                        send_raw=conn.send_raw,
                    )
                    if raw is None:  # close/EOF/oversize
                        break
                    if not raw:  # zero-length text frame: legal, not EOF
                        continue
            except OSError:
                break
            try:
                message = json.loads(raw)
            except ValueError:
                continue
            try:
                self._handle_peer_message(conn.peer_id, message)
            except Exception as err:  # noqa: BLE001
                self.emit("error", err)
        # disconnect handling (bullet-network.js:248-259); conn.close() tears
        # down the socket AND joins the writer — a link whose reader exited
        # must not leave its writer thread parked on the outbox forever
        conn.close()
        with self._lock:
            if self.peers.get(conn.peer_id) is conn:
                del self.peers[conn.peer_id]
        self.emit("peer:disconnect", conn.peer_id)
        if (
            not self._closed
            and conn.outbound
            and conn.url
            and conn.url in self.options["peers"]
        ):
            self._schedule_reconnect(conn.url)

    # -------------------------------------------------------------- messages

    def _handle_peer_message(self, peer_id: str, message: dict) -> None:
        """Dedup, dispatch, relay (bullet-network.js:286-324)."""
        if not isinstance(message, dict) or not message.get("type"):
            return
        msg_id = message.get("id")
        if msg_id is not None:
            with self._lock:
                if msg_id in self.processed_messages:
                    return
                self._remember_message(msg_id)

        self.emit("message", peer_id, message)

        mtype = message["type"]
        if mtype in ("handshake", "handshake-response"):
            return
        if mtype == "put":
            self._handle_put(peer_id, message)
        elif not mtype.startswith("sync-"):
            self.emit("unknown-message", peer_id, message)

    def _handle_put(self, peer_id: str, message: dict) -> None:
        """Apply a remote put and relay it (bullet-network.js:332-346).

        The reference's wire format only carries clocks inside object
        payloads, so its scalar flood applies as a LOCAL write and its
        array flood DISCARDS the clock element it went to the trouble of
        appending (bullet-crt.js:373-374) — cross-peer scalar/array puts
        then resolve by arrival order instead of causally. bullet_tpu_torch
        puts carry a top-level ``vectorClock`` for non-object data (a
        superset the reference both ignores and relays intact,
        bullet-network.js:332-346), and the receiver resolves under it;
        ``clocked_puts: False`` restores the reference's clockless
        apply. Object payloads are reference-exact either way."""
        path, data, ttl = message.get("path"), message.get("data"), message.get("ttl")
        if ttl is not None and ttl <= 0:
            return
        clock = None
        if isinstance(data, dict):
            network_data = {**data, "__fromNetwork": True}
        else:
            network_data, embedded = strip_array_clock(data)
            if self.options["clocked_puts"]:
                clock = embedded or message.get("vectorClock") or None
        self.bullet.set_data(
            path, network_data, broadcast=False, incoming_clock=clock
        )
        self._relay_message(message, peer_id)

    def _remember_message(self, msg_id: str) -> None:
        """Record a message id in the dedup set, pruning the oldest 10% past
        the cap. Called under self._lock; used by BOTH the receive and the
        broadcast/relay paths — a write-heavy node with little inbound
        traffic would otherwise grow the set unboundedly."""
        self.processed_messages[msg_id] = None
        cache_size = self.options["message_cache_size"]
        if len(self.processed_messages) > cache_size:
            for key in list(self.processed_messages)[: cache_size // 10]:
                del self.processed_messages[key]

    def send_to_peer(self, peer_id: str, message: dict) -> bool:
        conn = self.peers.get(peer_id)
        if conn is None or not conn.open:
            return False
        return conn.send(message)

    sendToPeer = send_to_peer

    def _relay_message(self, message: dict, source_peer_id: str) -> None:
        """TTL-decremented relay to everyone but the source
        (bullet-network.js:378-396)."""
        ttl = message.get("ttl")
        if ttl is not None and ttl <= 0:
            return
        relay = {
            **message,
            "id": message.get("id") or self._generate_id(),
            "ttl": (ttl if ttl is not None else self.options["max_ttl"]) - 1,
        }
        with self._lock:
            self._remember_message(relay["id"])
            peer_ids = list(self.peers)
        for peer_id in peer_ids:
            if peer_id != source_peer_id:
                self.send_to_peer(peer_id, relay)

    def broadcast(self, path: str, data: Any, vector_clock=None) -> None:
        """Flood a put to all peers (bullet-network.js:404-418).

        Non-object payloads additionally carry a top-level
        ``vectorClock`` (see _handle_put): real bullet-js peers ignore
        the extra field and relay it intact, bullet_tpu_torch peers use it to
        apply scalar floods causally instead of by arrival order."""
        message = {
            "id": self._generate_id(),
            "type": "put",
            "path": path,
            "data": data,
            "ttl": self.options["max_ttl"],
        }
        if (
            vector_clock
            and self.options["clocked_puts"]
            and not isinstance(data, (dict, list))  # objects embed theirs
        ):
            message["vectorClock"] = dict(vector_clock)
        with self._lock:
            self._remember_message(message["id"])
            peer_ids = list(self.peers)
        for peer_id in peer_ids:
            self.send_to_peer(peer_id, message)

    def _generate_id(self) -> str:
        return (
            f"{self.local_peer_id[:8]}-{int(time.time() * 1000)}-"
            f"{random.randrange(36**9):09x}"
        )

    # ------------------------------------------------------------------ sync

    def request_sync(self, peer_id: Optional[str] = None, options=None) -> None:
        """Explicit sync with one or all peers (bullet-network.js:437-451)."""
        if self.sync is None:
            return
        if peer_id:
            self.sync.request_sync(peer_id, options)
        else:
            for pid in list(self.peers):
                self.sync.request_sync(pid, options)

    requestSync = request_sync

    def get_sync_stats(self):
        if self.sync is None:
            return None
        return self.sync.get_sync_stats()

    getSyncStats = get_sync_stats

    # ----------------------------------------------------------------- close

    def close(self) -> None:
        """Tear down sync, links, server — deterministically. The reference's
        ``close()`` really ends its accept path (``wss.close()``,
        bullet-network.js:469-497); ours must too: a thread blocked in
        ``accept()`` is NOT woken by ``close()`` on Linux, so shut the
        listener down (and connect-to-self as a portable fallback), wake every
        pending handshake/dial socket, then JOIN every thread this network
        ever started. Anything else leaks one accept thread per test for the
        life of the process."""
        self._closed = True
        if self.sync is not None:
            self.sync.close()
        for timer in self._reconnect_timers:
            timer.cancel()
        with self._lock:
            conns = list(self.peers.values())
            self.peers.clear()
            self.processed_messages.clear()
            pending = list(self._pending_socks)
            self._pending_socks.clear()
        for conn in conns:
            conn.close()
        for sock in pending:  # wake handshake/dial threads blocked on IO
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        srv = self.server_socket
        if srv is not None:
            self.server_socket = None
            try:
                # Linux wakes a blocked accept() with EINVAL on shutdown
                srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                # some platforms refuse shutdown on a listener: dial
                # ourselves so accept() returns, sees _closed, and exits
                try:
                    with socket.create_connection(
                        ("127.0.0.1", self.port), timeout=1.0
                    ):
                        pass
                except OSError:
                    pass
            try:
                srv.close()
            except OSError:
                pass
        deadline = time.time() + 10.0
        for t in self._threads:
            if t is threading.current_thread():
                continue
            t.join(timeout=max(0.1, deadline - time.time()))
            if t.is_alive():  # pragma: no cover - teardown diagnostics
                self.emit(
                    "error",
                    RuntimeError(f"thread {t.name} survived network close()"),
                )
        self._threads.clear()
