"""Per-peer HTTP status endpoints + a network monitor aggregator.

The reference's multi-process examples expose a tiny HTTP ``/status``
endpoint per peer and a central monitor that polls them all and serves an
aggregated network view:

- per-node status server: examples/bullet-chain-example.js:153-182 and
  examples/bullet-circle-network-example.js:118-139 (JSON payload with
  nodeId, status, visible network data, timestamp);
- central aggregator: examples/bullet-circle-network-example.js:213-274
  (fetches every node's ``/status``, answers
  ``{networkSize, timestamp, nodes: [...]}``, marks unreachable nodes as
  errors) and examples/bullet-chain-example.js:264-321 (same, sorted by
  chain position).

Here that surface is a first-class library feature instead of inline
worker-script boilerplate: attach a :class:`StatusServer` to any
:class:`~bullet_tpu_torch.db.core.Bullet` instance and it serves a JSON
``/status`` enriched with live sync stats; point a :class:`MonitorServer`
at a list of status URLs and it serves the aggregated view (and offers
``collect()`` for in-process consumption without HTTP polling loops).

Everything is stdlib (``http.server`` + ``urllib``): zero new deps, same
as the reference's use of Node's built-in ``http``.

The port's own copy of ``bullet_tpu/db/monitor.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, List, Optional


def _iso_now() -> str:
    """ISO-8601 UTC timestamp, matching `new Date().toISOString()`."""
    return (
        datetime.now(timezone.utc)
        .isoformat(timespec="milliseconds")
        .replace("+00:00", "Z")
    )


class _JsonHandler(BaseHTTPRequestHandler):
    """Shared GET-only JSON handler: ``/status`` → payload, else 404
    (reference answers 404 'Not found' on any other path,
    examples/bullet-circle-network-example.js:131-134)."""

    # set per-subclass by the factory
    build_payload: Callable[[], dict]

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] == "/status":
            try:
                payload = type(self).build_payload()
                body = json.dumps(payload, indent=2, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as err:  # noqa: BLE001 - surface as HTTP 500
                body = json.dumps({"error": str(err)}).encode()
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
        else:
            body = b"Not found"
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


def _serve(build_payload: Callable[[], dict], host: str, port: int):
    """Start a threaded HTTP server for ``/status`` and return it."""
    handler = type("Handler", (_JsonHandler,), {"build_payload": staticmethod(build_payload)})
    server = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(
        target=server.serve_forever, daemon=True, name="bullet-status"
    )
    thread.start()
    return server, thread


class StatusServer:
    """Live HTTP ``/status`` endpoint for one Bullet peer.

    Default payload mirrors the union of the reference's two per-node
    status shapes (chain: nodeId/status/dataUpdateCount/visibleNodes/
    timestamp; circle: nodeId/status/network/timestamp) plus the sync
    stats the reference exposes separately via ``getSyncStats()``
    (src/bullet-network-sync.js:797-836).

    Parameters
    ----------
    bullet:
        the instance to report on.
    port:
        TCP port; 0 picks a free one (read it back from ``.port``).
    network_path:
        store path whose value is included as ``network`` (the reference
        reports ``bullet.get('nodes').value()``); None omits it.
    extra:
        optional callable returning a dict merged into the payload —
        the hook for example-specific fields like chain ``position``.
    """

    def __init__(
        self,
        bullet,
        port: int = 0,
        host: str = "127.0.0.1",
        network_path: Optional[str] = "nodes",
        extra: Optional[Callable[[], dict]] = None,
    ) -> None:
        self.bullet = bullet
        self.network_path = network_path
        self.extra = extra
        self._server, self._thread = _serve(self._payload, host, port)
        self.host = host
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}/status"

    def _payload(self) -> dict:
        bullet = self.bullet
        payload = {
            "nodeId": bullet.id,
            "status": "online",
            "timestamp": _iso_now(),
            "peers": sorted(bullet.network.peers) if bullet.network else [],
            "logLength": len(bullet.log),
            "metaPaths": len(bullet.meta),
        }
        if self.network_path is not None:
            network = bullet.get(self.network_path).value() or {}
            payload["network"] = network
            payload["visibleNodes"] = (
                len(network) if isinstance(network, dict) else 0
            )
        if bullet.network is not None:
            payload["syncStats"] = bullet.network.get_sync_stats()
        if self.extra is not None:
            payload.update(self.extra())
        return payload

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "StatusServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def fetch_status(url: str, timeout: float = 5.0) -> dict:
    """GET one peer's ``/status`` and parse the JSON
    (reference fetchNodeStatus,
    examples/bullet-circle-network-example.js:282-306)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


class MonitorServer:
    """Central aggregator over many peers' ``/status`` endpoints.

    ``collect()`` polls every registered URL (concurrently — the
    reference polls serially, which makes one dead node stall the whole
    sweep by its timeout) and returns
    ``{"networkSize", "timestamp", "nodes": [...]}`` with per-node
    ``status: "online" | "error"`` exactly like
    examples/bullet-circle-network-example.js:220-257. The same payload
    is served over HTTP at ``/status`` when ``port`` is given.
    """

    def __init__(
        self,
        status_urls: Iterable[str],
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        timeout: float = 5.0,
    ) -> None:
        self.status_urls: List[str] = list(status_urls)
        self.timeout = timeout
        self._server = None
        self._thread = None
        self.host = host
        self.port = None
        self.url = None
        if port is not None:
            self._server, self._thread = _serve(self.collect, host, port)
            self.port = self._server.server_address[1]
            self.url = f"http://{host}:{self.port}/status"

    def add(self, status_url: str) -> None:
        self.status_urls.append(status_url)

    def collect(self) -> dict:
        results: List[Optional[dict]] = [None] * len(self.status_urls)

        def probe(i: int, url: str) -> None:
            node_id = i + 1
            try:
                status = fetch_status(url, timeout=self.timeout)
                results[i] = {"nodeId": node_id, "status": "online", **status}
            except Exception as err:  # noqa: BLE001 - dead peer = error row
                results[i] = {
                    "nodeId": node_id,
                    "status": "error",
                    "url": url,
                    "error": str(err),
                }

        threads = [
            threading.Thread(target=probe, args=(i, url), daemon=True)
            for i, url in enumerate(self.status_urls)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout + 1.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return {
            "networkSize": len(self.status_urls),
            "timestamp": _iso_now(),
            "nodes": [
                r
                if r is not None
                else {"nodeId": i + 1, "status": "error", "error": "timeout"}
                for i, r in enumerate(results)
            ],
        }

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None

    def __enter__(self) -> "MonitorServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
