from . import gossip, topology
from .topology import Topology

__all__ = ["gossip", "topology", "Topology"]
