"""bullet_tpu_torch — the PyTorch + CUDA port of the bullet_tpu engine.

Mirrors the module layout of ``bullet_tpu`` (the JAX reference, which stays
in the repository unchanged): the counterpart of ``bullet_tpu/X/Y.py`` is
``bullet_tpu_torch/X/Y.py``. Tables are NamedTuples of int32 tensors on an
explicit device; on a CUDA device the hot loops run hand-written kernels
from ``csrc/`` (built on first use by ``_build``). Importing this package
imports no JAX.
"""

from .models.netsim import PeerNetworkSim
from .ops.merge import TableState


def __getattr__(name):
    # the predicate DSL resolves on first use, as in the reference package
    if name in ("P", "Predicate"):
        from .ops import predicates

        return getattr(predicates, name)
    raise AttributeError(name)


__all__ = ["PeerNetworkSim", "TableState", "P", "Predicate"]
