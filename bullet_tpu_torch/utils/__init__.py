"""Host-side value encoding, path interning and JS value semantics (numpy
only; the port's own copies of ``bullet_tpu/utils``)."""

from . import encode, jsvalues, paths
from .encode import ValueInterner
from .paths import PathInterner

__all__ = ["encode", "jsvalues", "paths", "PathInterner", "ValueInterner"]
