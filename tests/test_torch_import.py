"""The port imports without JAX, and nothing on the CPU tries to build the
CUDA kernels."""

import os
import subprocess
import sys

import pytest
import torch

from bullet_tpu_torch import _build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import numpy as np
import bullet_tpu_torch
import bullet_tpu_torch.convert
import bullet_tpu_torch.models.node
import bullet_tpu_torch.ops.packed
import bullet_tpu_torch.ops.ring_kernel
import bullet_tpu_torch.parallel.gossip
from bullet_tpu_torch import PeerNetworkSim, _build

sim = PeerNetworkSim(16, capacity=256, device="cpu", use_kernels=True)
sim.put_bulk(np.arange(16), [f"k/{i}" for i in range(16)], np.arange(16))
sim.step(1)
sim.run_until_converged()
sim.reconcile()
assert sim.tables_equal()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert _build._lib is None and _build.build_seconds is None
assert sum(_build.LAUNCHES.values()) == 0
print("ok")
"""


def test_import_is_jax_free_and_cpu_never_builds():
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().endswith("ok")


def test_library_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.library()
