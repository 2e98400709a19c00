"""bullet_tpu_torch — the PyTorch + CUDA port of bullet_tpu.

Mirrors the module layout of ``bullet_tpu`` (the JAX reference, which stays
in the repository unchanged): the counterpart of ``bullet_tpu/X/Y.py`` is
``bullet_tpu_torch/X/Y.py``. The host ``db`` layer is the reference
package's own (a copy, bullet-js's API); the ``models``/``ops``/``parallel``
packages are the simulation engine, whose tables are NamedTuples of int32
tensors on an explicit device; on a CUDA device the hot loops run
hand-written kernels from ``csrc/`` (built on first use by ``_build``).
Importing this package imports no JAX, and no torch until the engine is
asked for.

Package entry mirrors bullet-js's index.js: default ``Bullet``, named
component exports, a ``create`` factory, and ``VERSION``.
"""

from .db.core import Bullet, BulletNode
from .db.crt import BulletCRT
from .db.middleware import BulletMiddleware
from .db.query import BulletQuery
from .db.serializer import BulletSerializer
from .db.storage import BulletMemoryStorage, BulletStorage
from .db.validation import BulletValidation, ValidationError

VERSION = "0.1.0"

# reference-style component aliases (index.js:8-14)
Storage = BulletStorage
Query = BulletQuery
Validation = BulletValidation
Middleware = BulletMiddleware
Serializer = BulletSerializer


def create(options=None) -> Bullet:
    """Factory mirroring ``module.exports.create`` (index.js:20)."""
    return Bullet(options)


def __getattr__(name):
    # the engine (torch), the network stack and the predicate DSL resolve
    # on first use, so the db layer alone imports neither
    if name == "Network":
        from .db.network import BulletNetwork

        return BulletNetwork
    if name == "FileStorage":
        from .db.file_storage import BulletFileStorage

        return BulletFileStorage
    if name == "PeerNetworkSim":
        from .models.netsim import PeerNetworkSim

        return PeerNetworkSim
    if name == "TableState":
        from .ops.merge import TableState

        return TableState
    if name in ("P", "Predicate"):
        from .ops import predicates

        return getattr(predicates, name)
    if name in ("initialize_multihost", "global_mesh", "is_multihost", "host_info"):
        from .parallel import multihost

        return getattr(multihost, name)
    raise AttributeError(name)


__all__ = [
    "Bullet",
    "BulletNode",
    "BulletCRT",
    "create",
    "VERSION",
    "Storage",
    "FileStorage",
    "Network",
    "Query",
    "Validation",
    "Middleware",
    "Serializer",
    "PeerNetworkSim",
    "TableState",
    "P",
    "Predicate",
    "initialize_multihost",
    "global_mesh",
    "is_multihost",
    "host_info",
]
