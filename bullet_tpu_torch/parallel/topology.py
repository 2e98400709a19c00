"""Peer-network topologies: the reference package's numpy-only module,
reused as it is.

``bullet_tpu.parallel.topology`` imports only numpy, but importing it as a
package member runs ``bullet_tpu/parallel/__init__.py``, which imports the
JAX gossip module. So the file is loaded by path under a name of this
package, keeping one source of truth without pulling in JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import bullet_tpu

_NAME = __name__ + "._source"
_PATH = Path(bullet_tpu.__file__).resolve().parent / "parallel" / "topology.py"


def _load():
    module = sys.modules.get(_NAME)
    if module is not None:
        return module
    spec = importlib.util.spec_from_file_location(_NAME, _PATH)
    module = importlib.util.module_from_spec(spec)
    # @dataclass resolves its string annotations through sys.modules
    sys.modules[_NAME] = module
    spec.loader.exec_module(module)
    return module


_source = _load()

Topology = _source.Topology
ring = _source.ring
chain = _source.chain
full_mesh = _source.full_mesh
star = _source.star
bridge = _source.bridge
from_adjacency = _source.from_adjacency
random_graph = _source.random_graph

__all__ = [
    "Topology", "ring", "chain", "full_mesh", "star", "bridge",
    "from_adjacency", "random_graph",
]
