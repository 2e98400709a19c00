"""The host db layer. The port's own copy of ``bullet_tpu/db/__init__.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from .core import Bullet, BulletNode
from .crt import BulletCRT
from .middleware import BulletMiddleware
from .monitor import MonitorServer, StatusServer
from .query import BulletQuery
from .serializer import BulletSerializer
from .storage import BulletMemoryStorage, BulletStorage
from .validation import BulletValidation, ValidationError

__all__ = [
    "Bullet",
    "BulletNode",
    "BulletCRT",
    "BulletMiddleware",
    "BulletQuery",
    "BulletSerializer",
    "BulletMemoryStorage",
    "BulletStorage",
    "BulletValidation",
    "MonitorServer",
    "StatusServer",
    "ValidationError",
]
