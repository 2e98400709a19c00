"""Minimal RFC 6455 WebSocket framing for wire interop with real bullet-js
peers.

The reference's only transport is the ``ws`` package speaking standard
WebSockets with JSON text messages and the peer id in an ``x-peer-id`` HTTP
header (bullet-js src/bullet-network.js:43-63, 72, 143-155). This
module implements exactly the subset that protocol needs — HTTP Upgrade
handshake (client + server), text/close/ping/pong frames, client-side
masking, fragmentation reassembly — so a bullet_tpu_torch node can join an actual
bullet-js network when peers use ``ws://`` URLs (NDJSON over TCP remains the
default transport between bullet_tpu_torch nodes).

The port's own copy of ``bullet_tpu/db/ws.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import Dict, Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

# Refuse absurd frames instead of allocating/blocking for them (the ws
# package enforces maxPayload=100MB by default); applies per frame and to
# the reassembled fragmented message.
MAX_MESSAGE_BYTES = 64 * 1024 * 1024


def accept_key(sec_websocket_key: str) -> str:
    """Sec-WebSocket-Accept for a client key (RFC 6455 §4.2.2)."""
    digest = hashlib.sha1((sec_websocket_key + _GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def encode_frame(payload: bytes, opcode: int = OP_TEXT, mask: bool = False) -> bytes:
    """One FIN frame. Clients MUST mask (RFC 6455 §5.3); servers must not."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0x00
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def read_frame(reader) -> Optional[Tuple[int, bool, bytes]]:
    """(opcode, fin, payload) from a buffered byte reader; None on EOF or a
    frame larger than MAX_MESSAGE_BYTES (caller drops the connection)."""
    header = reader.read(2)
    if len(header) < 2:
        return None
    b0, b1 = header
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        ext = reader.read(2)
        if len(ext) < 2:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = reader.read(8)
        if len(ext) < 8:
            return None
        n = struct.unpack(">Q", ext)[0]
    if n > MAX_MESSAGE_BYTES:
        return None
    key = b""
    if masked:
        key = reader.read(4)
        if len(key) < 4:
            return None
    payload = reader.read(n) if n else b""
    if len(payload) < n:
        return None
    if masked:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


def read_message(reader, sock, client_side: bool, send_raw=None) -> Optional[str]:
    """Next complete text message; transparently answers pings and handles
    continuation frames. None on close/EOF/oversize.

    ``send_raw(frame_bytes)`` routes control replies (pong, close echo).
    When the connection has a dedicated writer thread, pass its enqueue
    here — writing straight to the socket from the reader thread would race
    the writer mid-``sendall`` and interleave bytes inside a data frame.
    Defaults to a direct socket write for standalone users (handshakes,
    tests)."""
    if send_raw is None:
        def send_raw(frame: bytes) -> None:
            sock.sendall(frame)

    parts: list = []
    total = 0
    while True:
        frame = read_frame(reader)
        if frame is None:
            return None
        opcode, fin, payload = frame
        if opcode == OP_PING:
            try:
                send_raw(encode_frame(payload, OP_PONG, mask=client_side))
            except OSError:
                return None
            continue
        if opcode == OP_PONG:
            continue
        if opcode == OP_CLOSE:
            try:
                send_raw(encode_frame(payload[:2], OP_CLOSE, mask=client_side))
            except OSError:
                pass
            return None
        if opcode in (OP_TEXT, OP_BINARY, OP_CONT):
            total += len(payload)
            if total > MAX_MESSAGE_BYTES:
                return None
            parts.append(payload)
            if fin:
                return b"".join(parts).decode("utf-8", "replace")


def _read_http_headers(reader) -> Optional[Dict[str, str]]:
    headers: Dict[str, str] = {}
    while True:
        line = reader.readline()
        if not line:
            return None
        line = line.rstrip(b"\r\n")
        if not line:
            return headers
        name, _, value = line.partition(b":")
        headers[name.decode("latin-1").strip().lower()] = (
            value.decode("latin-1").strip()
        )


def server_handshake(reader, sock, request_line: bytes) -> Optional[Dict[str, str]]:
    """Complete an HTTP Upgrade from the server side. ``request_line`` is the
    already-consumed first line (the transport auto-detects WS by its
    ``GET `` prefix). Returns the request headers (incl. x-peer-id) or None
    after writing an error response."""
    if not request_line.startswith(b"GET "):
        return None
    headers = _read_http_headers(reader)
    if headers is None:
        return None
    key = headers.get("sec-websocket-key")
    if (
        not key
        or headers.get("upgrade", "").lower() != "websocket"
    ):
        try:
            sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        except OSError:
            pass
        return None
    response = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    )
    sock.sendall(response.encode("latin-1"))
    return headers


def client_handshake(
    sock, reader, host: str, port: int, headers: Dict[str, str], path: str = "/"
) -> bool:
    """Send the HTTP Upgrade request and validate the 101 response."""
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    lines = [
        f"GET {path} HTTP/1.1",
        f"Host: {host}:{port}",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Key: {key}",
        "Sec-WebSocket-Version: 13",
    ]
    lines += [f"{name}: {value}" for name, value in headers.items()]
    sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    status_parts = reader.readline().split(b" ")
    if len(status_parts) < 2 or status_parts[1] != b"101":
        return False
    resp = _read_http_headers(reader)
    if resp is None:
        return False
    return resp.get("sec-websocket-accept") == accept_key(key)
