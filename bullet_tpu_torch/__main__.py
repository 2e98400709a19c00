"""Standalone peer CLI: run a bullet_tpu_torch database node.

    python -m bullet_tpu_torch serve --port 8765 --storage ./data \
        --peers tcp://host:8765 tcp://other:8766

The reference's ``npm start`` pointed at a nonexistent server script
(package.json:10); this is the working equivalent.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def serve(args) -> int:
    import bullet_tpu_torch as bt

    options = {
        "host": args.host,
        "port": args.port,
        "peers": args.peers or [],
        "storage": args.storage is not None,
        "storage_path": args.storage or "./.bullet",
        "enable_storage_log": args.verbose,
    }
    if args.encrypt_key:
        options["encrypt"] = True
        options["encryption_key"] = args.encrypt_key

    bullet = bt.create(options)
    peer_port = bullet.network.port if bullet.network else None
    print(f"bullet_tpu_torch peer {bullet.id}")
    print(f"listening on tcp://{args.host}:{peer_port}")
    if args.peers:
        print(f"dialing: {', '.join(args.peers)}")
    if args.storage:
        print(f"storage: {args.storage}")

    if args.verbose and bullet.middleware is not None:
        bullet.on("all", lambda event, data: print(f"[{event}]", flush=True))
    if bullet.network is not None:
        bullet.network.on(
            "peer:connect", lambda pid: print(f"[peer:connect] {pid}", flush=True)
        )
        bullet.network.on(
            "peer:disconnect",
            lambda pid: print(f"[peer:disconnect] {pid}", flush=True),
        )

    stop = threading.Event()

    def shutdown(signum, frame):
        print("\nshutting down...", flush=True)
        stop.set()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    stop.wait()
    bullet.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bullet_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_serve = sub.add_parser("serve", help="run a database peer node")
    p_serve.add_argument("--host", default="0.0.0.0")
    p_serve.add_argument("--port", type=int, default=8765)
    p_serve.add_argument("--peers", nargs="*", default=None,
                         help="peer URLs (tcp://host:port)")
    p_serve.add_argument("--storage", default=None,
                         help="storage directory (omit for in-memory)")
    p_serve.add_argument("--encrypt-key", default=None)
    p_serve.add_argument("--verbose", action="store_true")
    p_serve.set_defaults(fn=serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
