#!/usr/bin/env python3
"""Time one checkpoint of a full-size rank1 ring on the card.

    python3 tools/time_checkpoint.py [--seed S] [--peers P] [--capacity N]

Builds a rank1 P x N ring (default 1024 x 2^20, 4.3 GB) on the card with
chip_smoke.py's phase 10 records (2^17 users, 2^15 products, 2^17
scores at random peers), converges it, saves it with ``save_checkpoint``
(``np.savez_compressed`` through pageable host memory) into
build/time_checkpoint/, loads it back with ``load_checkpoint`` and checks
the loaded sim's value ids and sampled reads against the saved sim's. It
prints the card's name and power limit, the save and load seconds, the
table's bytes, the bytes on disk and the rates. Needs one CUDA device;
imports nothing of JAX. The files are removed at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_checkpoint: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    from bullet_tpu_torch import PeerNetworkSim, _build

    _build.library()
    dev = torch.device("cuda", 0)
    p, n = args.peers, args.capacity
    rng = np.random.default_rng(args.seed + 10)
    sim = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device=dev)
    for batch in chip_smoke.query_batches(rng, p, n):
        sim.put_bulk(*batch)
    rounds = sim.run_until_converged()
    directory = "build/time_checkpoint"
    shutil.rmtree(directory, ignore_errors=True)
    secs: dict = {}
    try:
        with chip_smoke.wall_window("save", secs):
            sim.save_checkpoint(directory)
        on_disk = sum(os.path.getsize(f"{directory}/{f}") for f in os.listdir(directory))
        with chip_smoke.wall_window("load", secs):
            loaded = PeerNetworkSim.load_checkpoint(directory, device=dev)
        if not chip_smoke.same_state(loaded, sim):
            raise AssertionError("time_checkpoint: the loaded value ids differ")
        paths = [sim.host.paths.path(int(i)) for i in rng.integers(0, len(sim.host.paths), 256)]
        peers = np.full(len(paths), p - 1, dtype=np.int32)
        if loaded.get_bulk(peers, paths) != sim.get_bulk(peers, paths):
            raise AssertionError("time_checkpoint: reads differ")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    table = sum(f.numel() * f.element_size() for f in sim.table)
    print(f"rank1 {p} x {n}, {len(sim.host.paths)} paths, {len(sim.host.values)} values, "
          f"converged in {rounds} rounds: save {secs['save']:.2f} s "
          f"({table / secs['save'] / 1e9:.3f} GB/s of table), load {secs['load']:.2f} s "
          f"({table / secs['load'] / 1e9:.3f} GB/s); table {table / 1e9:.3f} GB, "
          f"{on_disk / 1e6:.1f} MB on disk; value ids and reads equal; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
