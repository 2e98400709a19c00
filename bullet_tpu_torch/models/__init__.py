from .netsim import PeerNetworkSim
from .table import GraphHost, flatten_value

__all__ = ["PeerNetworkSim", "GraphHost", "flatten_value"]
