"""Peer-network topologies as adjacency structures.

The reference wires topologies by hand with one OS process per peer and
WebSocket URLs (ring: examples/bullet-circle-network-example.js:166-207,
chain: bullet-chain-example.js, bridge: bullet-bridge-example.js:226-296).
Here a topology is data: a neighbor-index matrix [P, max_deg] (-1 padded)
plus a structure tag that unlocks collective fast paths in
``parallel.gossip`` (ring/chain → shifts, mesh → recursive doubling).
``drop_links``/``drop_peer`` support fault injection — the partition
experiments the reference docs only discuss
(docs/network-topologies.md:235-240).

The port's own copy of ``bullet_tpu/parallel/topology.py`` (numpy only),
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Topology:
    name: str
    num_peers: int
    neighbors: np.ndarray  # [P, max_deg] int32, -1 padded
    kind: str = "generic"  # generic | ring | chain | mesh
    diameter: int = 0

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    def degree(self) -> np.ndarray:
        return (self.neighbors >= 0).sum(axis=1)

    def adjacency(self) -> np.ndarray:
        adj = np.zeros((self.num_peers, self.num_peers), dtype=bool)
        for p in range(self.num_peers):
            for q in self.neighbors[p]:
                if q >= 0:
                    adj[p, q] = True
        return adj

    def validate_symmetric(self) -> bool:
        adj = self.adjacency()
        return bool((adj == adj.T).all())

    def strong_components(self) -> np.ndarray:
        """Per-peer strongly-connected-component ids (iterative Tarjan).

        Ids ascend in REVERSE topological order of the condensation: every
        pull edge u→v (v ∈ neighbors[u]) that crosses components satisfies
        comp[v] < comp[u] — so processing components by ascending id
        visits each component after everything it pulls from, exactly the
        order the general reconcile's dynamic program needs."""
        n = self.num_peers
        adj = [
            [int(q) for q in self.neighbors[p] if q >= 0] for p in range(n)
        ]
        index = [-1] * n
        low = [0] * n
        on_stack = [False] * n
        comp = np.full(n, -1, dtype=np.int32)
        tarjan_stack: list = []
        counter = 0
        cid = 0
        for root in range(n):
            if index[root] != -1:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter
                    counter += 1
                    tarjan_stack.append(v)
                    on_stack[v] = True
                descended = False
                i = pi
                while i < len(adj[v]):
                    w = adj[v][i]
                    if index[w] == -1:
                        work[-1] = (v, i + 1)
                        work.append((w, 0))
                        descended = True
                        break
                    if on_stack[w]:
                        low[v] = min(low[v], index[w])
                    i += 1
                if descended:
                    continue
                if low[v] == index[v]:
                    while True:
                        w = tarjan_stack.pop()
                        on_stack[w] = False
                        comp[w] = cid
                        if w == v:
                            break
                    cid += 1
                work.pop()
                if work:
                    u, _ = work[-1]
                    low[u] = min(low[u], low[v])
        return comp

    def is_connected(self) -> bool:
        """True iff the topology is STRONGLY connected (every peer reaches
        every peer along neighbor edges). Gossip is pull-based — peer p
        merges FROM its neighbor list — so on a directed (asymmetric)
        topology a value only spreads against the edge direction; weak
        connectivity is not enough for the fixed point to be the global
        join. Strong connectivity ⇔ every peer is reachable from peer 0 in
        the graph AND in its transpose. Symmetric topologies (all
        built-ins) reduce to plain connectivity. Single-peer topologies
        count as connected."""
        if self.num_peers <= 1:
            return True
        adj = self.adjacency()

        def reaches_all(a: np.ndarray) -> bool:
            seen = np.zeros(self.num_peers, dtype=bool)
            seen[0] = True
            frontier = [0]
            while frontier:
                nxt = []
                for u in frontier:
                    for v in np.nonzero(a[u])[0]:
                        if not seen[v]:
                            seen[v] = True
                            nxt.append(int(v))
                frontier = nxt
            return bool(seen.all())

        return reaches_all(adj) and reaches_all(adj.T)

    # ------------------------------------------------------- fault injection

    def drop_links(self, links: Sequence[Tuple[int, int]]) -> "Topology":
        """Return a topology with the given undirected links removed."""
        dropped = {(a, b) for a, b in links} | {(b, a) for a, b in links}
        adj = self.adjacency()
        for a, b in dropped:
            adj[a, b] = False
        return from_adjacency(adj, name=f"{self.name}-partitioned")

    def drop_peer(self, peer: int) -> "Topology":
        """Simulate a peer failure: all its links go down."""
        adj = self.adjacency()
        adj[peer, :] = False
        adj[:, peer] = False
        return from_adjacency(adj, name=f"{self.name}-minus-{peer}")


def _pack(neigh_lists: List[List[int]], name: str, kind: str, diameter: int) -> Topology:
    num_peers = len(neigh_lists)
    max_deg = max((len(ns) for ns in neigh_lists), default=0) or 1
    arr = np.full((num_peers, max_deg), -1, dtype=np.int32)
    for p, ns in enumerate(neigh_lists):
        arr[p, : len(ns)] = sorted(ns)
    return Topology(name, num_peers, arr, kind, diameter)


def ring(num_peers: int) -> Topology:
    """Each peer links to both ring neighbors (the 14-node circle example)."""
    ns = [
        [(p - 1) % num_peers, (p + 1) % num_peers] for p in range(num_peers)
    ]
    return _pack(ns, "ring", "ring", num_peers // 2)


def chain(num_peers: int) -> Topology:
    """Linear chain, diameter P-1 (the 32-node chain example)."""
    ns = [
        [q for q in (p - 1, p + 1) if 0 <= q < num_peers]
        for p in range(num_peers)
    ]
    return _pack(ns, "chain", "chain", num_peers - 1)


def full_mesh(num_peers: int) -> Topology:
    ns = [[q for q in range(num_peers) if q != p] for p in range(num_peers)]
    return _pack(ns, "mesh", "mesh", 1)


def star(num_peers: int, hub: int = 0) -> Topology:
    ns = [
        [q for q in range(num_peers) if q != p] if p == hub else [hub]
        for p in range(num_peers)
    ]
    return _pack(ns, "star", "generic", 2)


def bridge(
    cluster_sizes: Sequence[int] = (5, 5), bridge_peers: int = 1
) -> Topology:
    """Full-mesh clusters joined through bridge node(s), mirroring
    examples/bullet-bridge-example.js:226-296 (2×5 mesh + 1 bridge)."""
    total = sum(cluster_sizes) + bridge_peers
    offsets = np.cumsum([0, *cluster_sizes]).tolist()
    ns: List[List[int]] = [[] for _ in range(total)]
    for c, size in enumerate(cluster_sizes):
        members = list(range(offsets[c], offsets[c] + size))
        for p in members:
            ns[p] = [q for q in members if q != p]
    bridges = list(range(offsets[-1], total))
    for b in bridges:
        for c, size in enumerate(cluster_sizes):
            gateway = offsets[c]  # first member of each cluster
            ns[b].append(gateway)
            ns[gateway].append(b)
    return _pack(ns, "bridge", "generic", 4)


def from_adjacency(adj: np.ndarray, name: str = "custom") -> Topology:
    adj = np.asarray(adj, dtype=bool)
    ns = [list(np.nonzero(adj[p])[0]) for p in range(adj.shape[0])]
    return _pack(ns, name, "generic", _bfs_diameter(adj))


def random_graph(num_peers: int, degree: int, seed: int = 0) -> Topology:
    """Random regular-ish gossip graph (each peer picks ``degree`` targets;
    links are symmetrized)."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((num_peers, num_peers), dtype=bool)
    for p in range(num_peers):
        targets = rng.choice(
            [q for q in range(num_peers) if q != p],
            size=min(degree, num_peers - 1),
            replace=False,
        )
        adj[p, targets] = True
    adj |= adj.T
    return from_adjacency(adj, name=f"random{degree}")


def _bfs_diameter(adj: np.ndarray) -> int:
    """Largest finite eccentricity (disconnected components ignored)."""
    n = adj.shape[0]
    best = 0
    for s in range(n):
        dist = np.full(n, -1)
        dist[s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for u in frontier:
                for v in np.nonzero(adj[u])[0]:
                    if dist[v] < 0:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            frontier = nxt
        if (dist >= 0).any():
            best = max(best, int(dist.max()))
    return best
