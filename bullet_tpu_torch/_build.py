"""Build and load the port's CUDA kernels, and count their launches.

The sources in ``csrc/`` have a plain C interface. On first use each is
compiled for Hopper by its own ``nvcc`` process, all started together, and
the objects are linked into one shared library under
``build/bullet_tpu_torch/<hash of the sources>/`` at the repository root,
loaded with ctypes. The build writes to a temporary file and renames it, so
two processes building at once cannot corrupt each other's library.

There is no fallback: without a CUDA device, or when ``nvcc`` is missing or
the build fails, ``library()`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "merge.cu", "ring_round.cu", "frontier_dense.cu", "frontier_shard.cu",
    "frontier_shard_window.cu", "compact_counts.cu",
    "apply_packed.cu", "packed_round.cu", "reconcile_packed.cu", "frontier_packed.cu",
    "window_packed.cu", "converge_columns.cu", "converge_graph.cu",
)
HEADERS = ("lexmax.cuh", "frontier.cuh")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "bullet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the last reset; each wrapper adds one where
# it launches its kernel, and nowhere else ("fused": the kernel's m > 1
# launches, counted apart from its single rounds)
LAUNCHES = {
    "merge": 0, "ring_round": 0, "ring_round_lean": 0, "frontier_round_dense": 0,
    "frontier_shard": 0, "frontier_shard fused": 0, "compact_counts": 0,
    "compact_counts fused": 0, "frontier_shard packed": 0, "frontier_shard packed fused": 0,
    "frontier_shard_window": 0, "compact_counts window": 0,
    "apply_packed": 0, "packed_round": 0, "packed_round fused": 0, "reconcile_packed": 0,
    "frontier_round_packed": 0, "window_packed": 0, "window_shard": 0, "converge_columns": 0,
    "converge_graph": 0,
}

_P = ctypes.c_void_p
_SIGNATURES = {
    # the dense-family kernels take the field count nf (7 full, 4 lean)
    # beside the lww flag
    "bt_merge": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P),
    "bt_ring_round": (
        _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_ring_round_lean": (_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P),
    "bt_frontier_round_dense": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_frontier_shard": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_frontier_shard_blocks": (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    # the fold's counts or stats, ids, then shards, m and t_total
    "bt_compact_counts": (_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    "bt_compact_counts_window": (_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P),
    # the packed-family kernels take the table's field count nf (1, 2, 3)
    # as their last argument before the stream
    "bt_frontier_shard_packed": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_frontier_shard_window": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_apply_packed": (
        _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P,
        ctypes.c_int, _P,
    ),
    "bt_packed_round": (
        _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_reconcile_packed": (_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P),
    "bt_frontier_round_packed": (
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_window_packed": (
        _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, _P,
    ),
    "bt_window_shard_packed": (
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
    "bt_window_rows": (ctypes.c_int,),
    "bt_converge_columns": (
        _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, _P,
    ),
    # fields, the groups and their masks, their count, the plan, the
    # neighbours, the schedule's length, the output cells and their count,
    # p, n, the cap, nf, the stream
    "bt_converge_graph": (
        _P, _P, ctypes.c_int, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
    ),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*HEADERS, *SOURCES):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = Path("/usr/local/cuda/bin/nvcc")
    if fixed.exists():
        return str(fixed)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(cmds) -> None:
    """Run the commands at once; raise with the output of any that fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as work:
        objs = [os.path.join(work, Path(src).stem + ".o") for src in SOURCES]
        _run([
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj]
            for src, obj in zip(SOURCES, objs)
        ])
        tmp = os.path.join(work, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the CUDA kernels cannot run")
        target = BUILD_ROOT / _source_hash() / "libbullet_kernels.so"
        start = time.perf_counter()
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - start
        _lib = lib
        return lib


def pointers(tensors) -> ctypes.Array:
    """A host array of device pointers, one per tensor."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def require_cuda(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel or plain version for {device}")


def check_fields(tensors, shape, device: torch.device, what: str) -> None:
    """Raise unless every tensor is contiguous int32 of ``shape`` on
    ``device`` — the layout the kernels index."""
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: tensor on {t.device}, expected {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")
