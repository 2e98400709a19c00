#!/usr/bin/env python3
"""chip_smoke.py phase 13's mesh paths with one process a card under NCCL.

    python3 tools/mesh_cards.py [--seed S] [--peers P] [--capacity N] ...

The four shards of phase 13's rings (packed and rank1 1024 x 2^20, dense
lww 1024 x 2^18 by default; chip_smoke.py's size options) over four
processes, one a card and one shard each, so that every boundary row,
slab, count and fold crosses between cards through NCCL. Each process
holds its shard against its own unsharded twin on its card and logs its
windows' wall seconds, the bytes it sent and received a mesh step and the
exchange's seconds beside its kernels'; every process's values must
equal the others' and each must launch the per-shard kernels of its
path. Prints every card's name and power limit. Needs four CUDA devices;
imports nothing of JAX."""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    args = chip_smoke.build_parser().parse_args()
    if torch.cuda.device_count() < chip_smoke.SHARDS:
        raise SystemExit(f"mesh_cards: needs {chip_smoke.SHARDS} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(cards, flush=True)
    from bullet_tpu_torch import _build

    _build.library()  # once, before the processes load it
    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = chip_smoke.run_processes(args, chip_smoke.SHARDS, "nccl", tmp)
    chip_smoke.check_processes("nccl", results, chip_smoke.PROCESS_KERNELS)
    print(f"mesh_cards: {chip_smoke.SHARDS} NCCL processes, one a card, in "
          f"{time.perf_counter() - started:.1f} s, values equal in all; "
          f"{cards.splitlines()[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
