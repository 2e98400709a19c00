from . import gossip, topology
from .topology import Topology

# the multi-process entry points (parallel/multihost.py); importing them
# starts no process group
MULTIHOST = ("initialize_multihost", "global_mesh", "is_multihost", "host_info")


def __getattr__(name):
    if name in MULTIHOST:
        from . import multihost

        return getattr(multihost, name)
    raise AttributeError(name)


__all__ = ["gossip", "topology", "Topology", *MULTIHOST]
