#!/usr/bin/env python3
"""Trace the device over the main paths of chip_smoke.py (its phases 4
to 9: the dense, the packed, the rank1 and the lean ring, the sharded
dense ring and the sharded packed and rank1 rings).

    python3 tools/profile_main.py [--seed S] [--peers P] [--capacity N] [--ops K]
                                  [--packed-capacity N] [--packed-ops K]
                                  [--rank1-capacity N] [--rank1-ops K]
                                  [--lean-capacity N] [--lean-ops K]

Runs the same main paths as ``chip_smoke.py`` (same data, windows and
checks) with each timed window under ``torch.profiler`` (CUDA activity
only). For each window it prints the wall seconds (the profiler's own cost
included), the device busy seconds (the union of the intervals of device
activity), the idle share 1 - busy / wall, and the device time of the
kernels that take most of it. The card's name and power limit come first.
Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

TOP = 6
# window name -> device events recorded in it
EVENTS: dict = {}
# The trace loses the first few device events after the profiler starts (on
# an H100: a window's first 2-4 launches and copies were missing, e.g. the
# whole count-only probe and reconcile windows). Marker kernels, launched
# and synchronised before the window opens, absorb that loss and are left
# out of every count.
LEAD_IN = 16
MARKER = "spin_kernel"  # the kernel torch.cuda._sleep launches


def busy_seconds(spans) -> float:
    """Length of the union of [start, end) intervals given in microseconds."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e6


@contextlib.contextmanager
def traced_window(name: str, seconds: dict):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        with chip_smoke.wall_window(name, seconds):
            yield
    events = [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and MARKER not in e.name
    ]
    EVENTS[name] = len(events)
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in events)
    wall = seconds[name]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    print(f"{name}: wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.4f}, device events {len(events)}", flush=True)
    for kname, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"    {kname[:72]:72s} {us / 1e3:10.3f} ms  x{count}", flush=True)


def main() -> int:
    args = chip_smoke.build_parser().parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    chip_smoke.main_path(args, dev, window=traced_window)
    torch.cuda.empty_cache()
    chip_smoke.packed_main_path(args, dev, window=traced_window)
    torch.cuda.empty_cache()
    chip_smoke.rank1_main_path(args, dev, window=traced_window, card=card)
    torch.cuda.empty_cache()
    chip_smoke.lean_main_path(args, dev, window=traced_window)
    torch.cuda.empty_cache()
    chip_smoke.sharded_main_path(args, dev, window=traced_window)
    torch.cuda.empty_cache()
    chip_smoke.sharded_packed_path(args, dev, window=traced_window, card=card)
    if not any(EVENTS.values()):
        raise RuntimeError(f"the profiler recorded no device activity: {EVENTS}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
