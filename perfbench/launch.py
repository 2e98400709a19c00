"""One process a card: the launcher of a cell whose configuration is sharded
over several cards (its ``shards`` above 1), as the port runs a mesh across
processes (``bullet_tpu_torch.parallel.multihost``).

The process the driver starts is rank 0. It starts ``world - 1`` copies of
its own script (``Workers``), each with ``--rank r --world w --coordinator
127.0.0.1:<port>``, before it imports torch itself, so that the processes
start side by side; it builds or loads the kernel library before it joins,
and no worker loads it before the join. Every process then joins the
process group (``join``:
NCCL between cards, gloo between CPU processes, each process on its own
device) and runs the same cell with the same seed, which is the port's
contract for a mesh of processes: the same calls in the same order.

A worker writes to rank 0's standard error, never to its standard output.
A worker that ends with a failure ends the run at once: rank 0 kills the
others and exits non-zero. A worker that stalls leaves its peers waiting in
a collective, which fails after ``TIMEOUT_S``. A worker dies with rank 0
(``die_with_parent``), so none outlives the run.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

# how long a collective waits for a process that died or stalled, and how
# long rank 0 waits for its workers to end after its own last collective
TIMEOUT_S = 120.0
# exit code of rank 0 when a worker failed first
WORKER_FAILED = 5
# the interface the processes of one machine talk over
LOOPBACK = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}
_PR_SET_PDEATHSIG = 1


def die_with_parent() -> None:
    """A worker's first call: the kernel kills it when rank 0 ends (and it
    leaves at once where rank 0 ended before this call)."""
    ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() == 1:
        raise SystemExit("launch: rank 0 ended before this worker started")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Workers:
    """Context manager over ranks 1 .. world - 1 of ``script``, started with
    ``argv`` and the rank, world and coordinator. On a clean exit it waits
    for every worker to end (``TIMEOUT_S`` at most) and raises
    ``SystemExit(WORKER_FAILED)`` where one failed; on an exception it
    kills them. While open, a worker's failure ends this process at once."""

    def __init__(self, script: str, argv: Sequence[str], world: int) -> None:
        self.script, self.argv, self.world = script, list(argv), world
        self.coordinator = f"127.0.0.1:{free_port()}"
        self.procs: List[subprocess.Popen] = []
        self._closing = threading.Event()
        self._watch: Optional[threading.Thread] = None

    def __enter__(self) -> "Workers":
        os.environ.update(LOOPBACK)
        for rank in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, self.script, *self.argv, "--rank", str(rank),
                 "--world", str(self.world), "--coordinator", self.coordinator],
                stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno(),
                stderr=sys.stderr.fileno()))
        self._watch = threading.Thread(target=self._watch_loop, daemon=True)
        self._watch.start()
        return self

    def _failed(self) -> List[tuple]:
        return [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                if p.poll() not in (None, 0)]

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _watch_loop(self) -> None:
        while not self._closing.wait(0.2):
            failed = self._failed()
            if failed:
                log(f"launch: worker (rank, exit code) {failed} failed; ending the run")
                self._kill()
                os._exit(WORKER_FAILED)

    def __exit__(self, exc_type, exc, tb) -> None:
        self._closing.set()
        self._watch.join()
        if exc_type is not None:
            self._kill()
            return
        deadline = time.monotonic() + TIMEOUT_S
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(self.procs, 1) if p.poll() is None]
        self._kill()
        failed = self._failed()
        if late or failed:
            log(f"launch: workers {late} did not end; (rank, exit code) {failed}")
            raise SystemExit(WORKER_FAILED)


def join(coordinator: str, world: int, rank: int, device: str, backend: str):
    """Join the process group as ``rank`` of ``world`` (a worker has
    ``LOOPBACK`` from rank 0's environment) and make the global mesh one
    shard a process, on ``device`` (a card: it becomes the current one).
    Returns the device."""
    import torch
    from bullet_tpu_torch.parallel.multihost import global_mesh, initialize_multihost

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_multihost(coordinator, world, rank, backend=backend, timeout_s=TIMEOUT_S)
    global_mesh([dev])
    return dev


def leave() -> None:
    """Leave the process group, so that no process warns at exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def add_arguments(ap) -> None:
    """A worker's arguments, which the driver never passes."""
    import argparse

    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)


def world(root, workload: str) -> int:
    """The processes a cell runs in: its configuration's ``shards`` (1 by
    default), read from BENCHMARK.json and the configuration's file alone,
    before anything imports torch."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return int(json.loads((Path(root) / entry["file"]).read_text()).get("shards", 1))


def spmd(args, argv: Sequence[str], script: str, world: int, device_type: str, backend: str,
         body: Callable, ready: Callable[[], None] = lambda: None):
    """``body(device)`` in every process of a world of ``world``: here
    alone where ``world`` is 1 (on ``device_type``, as it is), else as rank
    0 beside ``world - 1`` workers started from ``script`` with ``argv``,
    or here as the worker that ``args.rank`` names. ``ready()`` runs first
    where this process is rank 0 (or alone), once its workers have started;
    it ends the run by raising, which kills them. Returns what ``body``
    returns (None in a worker)."""
    def device(rank: int) -> str:
        return f"cuda:{rank}" if device_type == "cuda" else device_type

    if args.rank is not None:
        body(join(args.coordinator, args.world, args.rank, device(args.rank), backend))
        leave()
        return None
    if world == 1:
        ready()
        return body(device_type)
    with Workers(script, argv, world) as workers:
        ready()
        if device_type == "cuda":
            from bullet_tpu_torch import _build

            _build.library()  # built or loaded once, before any worker loads it
        out = body(join(workers.coordinator, world, 0, device(0), backend))
        leave()
    return out
