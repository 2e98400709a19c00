"""PeerNetworkSim on PyTorch: P replicated peers, one graph table each.

The port of ``bullet_tpu.models.netsim`` for the dense (7 fields,
28 B/entry) layout, with lean gossip, and the packed family, reference
mode only: packed (3 fields, 12 B/entry), rank (2 fields, 8 B/entry) and
rank1 (1 field, 4 B/entry; see ops/rank.py); every layout on one device
or on a device mesh:

    step = apply op batch  ->  gossip round(s) over the topology

with the tables resident on ``device``. On a CUDA device the op apply
(packed family), the ring/chain rounds, the compacting frontier
convergence, the window joins of ``fast_forward``, the reconcile and the
graph pass (the rounds of every other topology but the full mesh) run the
hand-written kernels of ``bullet_tpu_torch/csrc``; on the CPU the same
routes run their plain PyTorch versions.
``use_kernels`` (default: the device is CUDA) picks the kernel routes, as
``use_pallas=True`` does in the reference package; only a CPU sim may turn
it off.

Lean gossip (``lean_gossip=True``, reference mode) exchanges only the four
value keys; writer, ctr and tick keep their locally written values. As in
the reference, the route decides the bits: the lean frontier and the lean
round (on the kernel route, where the reference's lean kernel takes the
shape) merge four fields, every other round all seven.

On a device mesh (``mesh_devices``: a count, or devices that may repeat)
the table is a ``ShardedTable`` split by peer rows. With ``use_shard_map``
its ring and chain sims converge on the per-shard frontier
(``dense-frontier-spmd``, ``packed-frontier-spmd``: on the card the
packed family takes m-round windows per boundary exchange, and an
uncapped converge one column pass a shard) where the
reference's sharded predicate holds; every sharded sim's rounds are the
explicit exchanges of ``parallel/shardmap_gossip.py``, and a packed
family's ``fast_forward`` takes one window per exchange of m-row slabs.
A data mesh (no ``use_shard_map``) never runs the frontier. A packed
family's op apply and reconcile run per shard.

A mesh may span processes (``parallel/multihost.py``: ``global_mesh()``,
or ``mesh_devices=k`` once ``torch.distributed`` runs a world larger than
one). Every process then runs the same program: it builds the sim with the
same arguments and calls the same methods in the same order with the
same arguments (puts included: ingress, the host's interners, the
RankIndex and the dirty stripes see the whole batch in every process,
which applies only its own shards' ops), and holds only its own shards.
Every method that reads or writes rows or counts across shards (step,
fast_forward, run_until_converged, converged, reconcile, get, get_bulk,
the queries, snapshot, restore, tables_equal) is then a collective, as it
is under the reference's multi-controller runtime, and returns the same
value in every process: counts and round counts are summed over the
processes, and a row is read from its owner.

The db facade goes through this package's own db layer: the
serializer's ``export_to_*``/``import_from_*`` through a scratch
``Bullet`` and ``models/bridge.py``, ``save_checkpoint``/
``load_checkpoint`` through ``models/checkpoint.py``; the live bridges of
``models/bridge.py`` keep their lock and stages on the sim.

Batch ingress (``models/ingress.py``) sits between the drain and the
apply: traced put transforms and the schemas' veto mask run on the
device over the whole drained batch (on a mesh, before it is split by
shard; on the packed family, before the host's reduction), put hooks and
the strict schema checks on the host at ``put``/``put_bulk``.

Convergence is deterministic: the merge is a join-semilattice, so
``run_until_converged`` reaches the unique fixed point in at most
diameter + 1 rounds, with the same round count as the reference.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import FROM_NUMPY, sharded_from_numpy, table_to_numpy
from ..ops import packed as pk
from ..ops import rank as rk
from ..ops import scans
from ..ops.apply import OpBatch, apply_ops
from ..ops.merge import TableState, init_table, lean_fields
from ..ops.predicates import Predicate, compile_predicate, predicate_params
from ..ops.ring_kernel import (
    beats_of,
    dense_frontier_available,
    dense_frontier_available_sharded,
)
from ..parallel import topology as topo
from ..parallel.gossip import gossip_round, gossip_round_mesh, until_converged
from ..parallel.mesh import (
    ShardedTable,
    all_sum_int,
    disjoint_sum,
    pad_peers_to_mesh,
    resolve_mesh,
)
from ..parallel.shardmap_gossip import (
    HALO_FUSE,
    data_mesh_round,
    gossip_columns_shardmap_packed,
    gossip_frontier_shardmap_dense,
    gossip_frontier_shardmap_packed,
    mesh_round_shardmap,
    reconcile_shardmap_packed,
    ring_window_shardmap_packed,
    shardmap_round,
)
from ..utils import observe
from ..utils.encode import CLS_ABSENT, CLS_NUMBER, VID_NULL, number_key
from .ingress import EngineHooks, EngineValidation, invalid_op_mask, traced_pipeline, veto_ops
from .table import MISSING, GraphHost, flatten_value

TopologyLike = Union[str, dict, topo.Topology]

# the layouts that share the packed-family kernels (keyed by field count:
# 3 = packed, 2 = rank, 1 = rank1)
PACKED_FAMILY = ("packed", "rank", "rank1")
# the layouts whose merge order rides a host-maintained RankIndex
RANK_FAMILY = ("rank", "rank1")


class ConvergenceCell(NamedTuple):
    """The dispatch-relevant shape of a convergence request. Built by
    ``PeerNetworkSim._convergence_cell``; consumed by the strategy table."""

    layout: str  # "dense" | "packed" | "rank" | "rank1"
    ring_chain: bool  # topology kind is ring or chain
    frontier: bool  # the frontier kernel tiles this shape (tile > 0)
    spmd: bool  # a mesh with use_shard_map
    data_mesh: bool  # any mesh
    kernels: bool  # use_kernels


# Convergence strategy table: (name, predicate, runner method name) — FIRST
# match wins; the rows and predicates are the reference package's.
CONVERGENCE_STRATEGIES: Tuple[Tuple[str, Callable, str], ...] = (
    (
        "packed-frontier-spmd",  # per-shard packed frontier, windows on the card (an
        # uncapped converge there: one column pass a shard)
        lambda c: c.layout in PACKED_FAMILY and c.spmd and c.frontier and c.ring_chain
        and c.kernels,
        "_converge_frontier_spmd",
    ),
    (
        "packed-frontier-local",  # packed-family compacting frontier, fused on the card
        lambda c: c.layout in PACKED_FAMILY and not c.spmd and not c.data_mesh and c.frontier
        and c.ring_chain and c.kernels,
        "_converge_frontier_local",
    ),
    (
        "packed-loop",  # packed-family whole-table round loop (any topology; on the
        # card a topology other than a ring, chain or full mesh takes the graph pass)
        lambda c: c.layout in PACKED_FAMILY,
        "_converge_packed_loop",
    ),
    (
        "dense-frontier-spmd",  # per-shard frontier on a mesh, fused on the card
        lambda c: c.layout == "dense" and c.spmd and c.frontier and c.ring_chain
        and c.kernels,
        "_converge_dense_frontier_spmd",
    ),
    (
        "dense-frontier",  # compacting frontier (full or lean), fused on the card
        lambda c: not c.spmd and not c.data_mesh and c.frontier and c.ring_chain
        and c.kernels,
        "_converge_dense_frontier",
    ),
    (
        "dense-loop",  # whole-table round loop (any topology)
        lambda c: True,
        "_converge_dense_loop",
    ),
)


def _group_positions(peers: np.ndarray, num_peers: int):
    """Within-batch sequence position of each op among its peer's ops, plus
    per-peer counts (stable order). Shared by put_bulk and _drain_ops so the
    Lamport stamps and dense batch positions can never diverge."""
    from .. import native

    fast = native.group_positions(peers, num_peers)
    if fast is not None:
        return fast
    k = len(peers)
    counts = np.bincount(peers, minlength=num_peers)
    order = np.argsort(peers, kind="stable")
    sorted_peers = peers[order]
    boundaries = np.flatnonzero(np.diff(sorted_peers)) + 1
    starts = np.concatenate(([0], boundaries))
    group_sizes = np.diff(np.concatenate((starts, [k])))
    seq_sorted = np.arange(k) - np.repeat(starts, group_sizes)
    seq = np.empty(k, dtype=np.int64)
    seq[order] = seq_sorted
    return seq, counts


# the keys of a topology spec (a JSON-able dict)
BRIDGE_SPEC_KEYS = {"kind", "clusters", "cluster_size", "bridge_peers"}


def _topology_of_spec(spec: dict, num_peers: int) -> topo.Topology:
    """A topology from a spec, ``{"kind": "bridge", "clusters": c,
    "cluster_size": s, "bridge_peers": b}``: ``topology.bridge((s,) * c,
    b)``, c full-mesh clusters of s peers joined through b bridge peers that
    each link to every cluster's first member
    (bullet-bridge-example.js:16-18,226-296)."""
    if spec.get("kind") != "bridge" or set(spec) != BRIDGE_SPEC_KEYS:
        raise ValueError(f"topology spec {spec!r}: a bridge spec has exactly the keys "
                         f"{sorted(BRIDGE_SPEC_KEYS)}")
    clusters, size, bridges = spec["clusters"], spec["cluster_size"], spec["bridge_peers"]
    if any(type(v) is not int for v in (clusters, size, bridges)):
        raise ValueError(f"topology spec {spec!r}: its sizes are whole numbers")
    if clusters < 1 or size < 1 or bridges < 0:
        raise ValueError(f"topology spec {spec!r}: sizes out of range")
    if clusters * size + bridges != num_peers:
        raise ValueError(f"topology spec {spec!r}: {clusters} x {size} + {bridges} peers "
                         f"!= num_peers {num_peers}")
    return topo.bridge((size,) * clusters, bridges)


def _resolve_topology(t: TopologyLike, num_peers: int) -> topo.Topology:
    if isinstance(t, topo.Topology):
        return t
    if isinstance(t, dict):
        return _topology_of_spec(t, num_peers)
    builders = {
        "ring": topo.ring,
        "chain": topo.chain,
        "mesh": topo.full_mesh,
        "full_mesh": topo.full_mesh,
        "star": topo.star,
    }
    if t == "bridge":
        # the bullet-js bridge example: 2 clusters × 5 + 1 bridge node
        if num_peers < 3:
            raise ValueError("bridge topology needs at least 3 peers")
        built = topo.bridge()
        if built.num_peers != num_peers:
            per = max(1, (num_peers - 1) // 2)
            built = topo.bridge((per, num_peers - 1 - per), 1)
        return built
    if t not in builders:
        raise ValueError(f"unknown topology: {t}")
    return builders[t](num_peers)


def _rekey(table: TableState, cls_map, khi_map, klo_map) -> TableState:
    """Refresh (cls, khi, klo) from vid after a string-rank rebalance
    (vids clamp into the map, as the reference's gathers do)."""
    present = table.cls > 0
    vid = table.vid.to(torch.int64).clamp_(0, cls_map.numel() - 1)
    return table._replace(
        cls=torch.where(present, cls_map[vid], table.cls),
        khi=torch.where(present, khi_map[vid], table.khi),
        klo=torch.where(present, klo_map[vid], table.klo),
    )


def _rekey_packed(table: pk.PackedTable, cls_map, khi_map, klo_map) -> pk.PackedTable:
    """Packed twin of ``_rekey``, in place on column blocks (a whole-table
    pass would need int64 temporaries several times the table)."""
    p, n = table.cv.shape
    width = max(1, (1 << 24) // max(p, 1))  # 2^24-entry blocks
    last = cls_map.numel() - 1
    for c0 in range(0, n, width):
        khi, klo, cv = (f[:, c0:c0 + width] for f in table)
        present = (cv >> pk.CV_SHIFT) > 0
        vid = cv & pk.VID_MASK
        idx = vid.to(torch.int64).clamp_(0, last)  # vids clamp, as in _rekey
        khi.copy_(torch.where(present, khi_map[idx], khi))
        klo.copy_(torch.where(present, klo_map[idx], klo))
        cv.copy_(torch.where(present, pk.pack_cv(cls_map[idx], vid), cv))
    return table


def _closure_join_packed(table, idx, members):
    """Packed-family twin of ``_closure_join_dense`` (reference mode): join
    rows ``table[idx]`` by roll-doubling, write the join to rows
    ``members``."""
    rows = type(table)(*(f[idx] for f in table))
    for s in range((len(idx) - 1).bit_length()):
        rows, _ = pk.merge_packed_torch(
            rows, type(table)(*(torch.roll(f, 1 << s, 0) for f in rows))
        )
    for f, r in zip(table, rows):
        f[members] = r[0]
    return table


def _join_rows(rows: List[torch.Tensor], beats) -> List[torch.Tensor]:
    """Join [K, N] rows by roll-doubling: after ceil(log2 K) steps row 0
    holds the join of all K. Returns its fields, each [N]."""
    for s in range((rows[0].shape[0] - 1).bit_length()):
        rolled = [torch.roll(f, 1 << s, 0) for f in rows]
        gt = beats(rolled, rows)
        rows = [torch.where(gt, b, a) for a, b in zip(rows, rolled)]
    return [r[0] for r in rows]


def _closure_join_dense(table: TableState, idx, members, mode: str, lean: bool) -> TableState:
    """Join rows ``table[idx]`` under ``mode``'s priority order (the four
    value keys only when ``lean``) and write the join to rows ``members``,
    in place — one step of the per-SCC reconcile (see
    PeerNetworkSim._reconcile_weak)."""
    fields = lean_fields(table) if lean else table
    joined = _join_rows([f[idx] for f in fields], beats_of(len(fields), mode))
    for f, r in zip(fields, joined):
        f[members] = r
    return table


def _clone(table):
    """A copy of a table, sharded or not."""
    copy = lambda t: type(t)(*(f.clone() for f in t))  # noqa: E731
    return table.map(copy) if isinstance(table, ShardedTable) else copy(table)


def _grown(table, capacity: int):
    """A copy of a table (one shard, or a single-device table) widened to
    ``capacity`` slots with absent (all-zero) entries."""
    grown = type(table)(*(
        torch.zeros((f.shape[0], capacity), dtype=f.dtype, device=f.device) for f in table
    ))
    for g, f in zip(grown, table):
        g[:, : f.shape[1]] = f
    return grown


def _pad_flat_ops(reduced, p: int, n: int, min_bucket: int = 64):
    """Pad a reduced flat op batch (rows peer, slot, then the fields) to a
    power-of-two length of at least ``min_bucket``: the batches of
    ``warm_apply_buckets``. Padding rows never change state: peer ``p - 1``
    at slots ``n + i``, outside the table, which the apply drops, with all
    value fields zero (cls 0 / rank 0, a loser); ascending slots keep the
    (peer, slot) pairs sorted and unique. A batch already at its bucket
    comes back as it is."""
    k = len(reduced[0])
    bucket = max(min_bucket, 1 << max(k - 1, 1).bit_length())
    if bucket == k:
        return reduced
    pad = bucket - k
    peer = np.concatenate([reduced[0], np.full(pad, p - 1, dtype=np.int32)])
    slot = np.concatenate([reduced[1], (n + np.arange(pad)).astype(np.int32)])
    rest = tuple(np.concatenate([r, np.zeros(pad, dtype=r.dtype)]) for r in reduced[2:])
    return (peer, slot, *rest)


class PeerNetworkSim:
    """P simulated peers over a topology, tables resident on ``device``.

    Parameters
    ----------
    num_peers : int — simulated peer count
    capacity : int — leaf-slot capacity (grows by doubling)
    topology : "ring" | "chain" | "mesh" | "star" | "bridge" | Topology
    mode : "reference" (converged-state parity) | "lww" (Lamport LWW)
    mesh_devices : int | sequence of devices | Mesh | None — shard the peer
        axis over a mesh (every layout): the first k devices of
        ``device``'s type (k virtual shards on the CPU; across processes,
        the first k of the global mesh), the devices given, which may
        repeat, or a ``Mesh`` (``multihost.global_mesh()``). P is padded up
        to a multiple of the mesh size
    use_kernels : bool | None — take the kernel routes (the compacting
        frontier in ``run_until_converged``, the lean round); default: the
        device is CUDA. A CUDA sim always takes them; on the CPU they run
        the kernels' plain versions, and False picks the whole-table round
        loop of full merges
    use_shard_map : bool — on a mesh, the explicit SPMD path: the
        per-shard frontier, the full-metadata exchange rounds and the
        packed star's hub reduce (without a mesh it changes nothing)
    lean_gossip : bool — gossip the four value keys only (reference mode;
        ignored in lww mode, as in the reference)
    layout : "dense" (7 fields, full metadata) | "packed" (3 fields,
        12 B/entry; see ops/packed.py) | "rank" (2 fields, 8 B/entry) |
        "rank1" (1 field, 4 B/entry; see ops/rank.py); the packed family
        runs in reference mode only
    device : where the tables live ("cuda", the default; "cpu"; a
        torch.device); on a mesh, the device of this process's first shard
    """

    def __init__(
        self,
        num_peers: int,
        capacity: int = 1024,
        topology: TopologyLike = "ring",
        mode: str = "reference",
        mesh_devices: Optional[Union[int, Sequence]] = None,
        use_kernels: Optional[bool] = None,
        use_shard_map: bool = False,
        lean_gossip: bool = False,
        layout: str = "dense",
        *,
        device="cuda",
    ) -> None:
        if layout not in ("dense",) + PACKED_FAMILY:
            raise ValueError(f"unknown layout: {layout}")
        if layout in PACKED_FAMILY and mode != "reference":
            raise ValueError(
                f"{layout} layout supports reference mode only "
                "(no writer/ctr metadata for lww priority)"
            )
        if mode not in ("reference", "lww"):
            raise ValueError(f"unknown merge mode: {mode}")
        self.layout = layout
        self.mode = mode
        self.use_shard_map = bool(use_shard_map)
        # lean gossip exchanges only the 4 value keys (reference mode):
        # writer/ctr/tick keep their last locally written values
        self.lean_gossip = bool(lean_gossip) and mode == "reference"
        self.mesh = resolve_mesh(mesh_devices, device) if mesh_devices else None
        if self.mesh is not None:
            num_peers = pad_peers_to_mesh(num_peers, self.mesh)
            device = self.mesh.home
        self.device = torch.device(device)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        elif not use_kernels and self.device.type == "cuda":
            raise ValueError(
                "use_kernels=False: a sim on a CUDA device always runs the kernels"
            )
        self.use_kernels = bool(use_kernels)
        self.num_peers = num_peers
        self.topology = _resolve_topology(topology, num_peers)
        if self.topology.num_peers != num_peers:
            raise ValueError("topology size != num_peers")
        self.host = GraphHost(capacity)
        if layout in RANK_FAMILY:
            # host order authority for the rank layouts: vid -> 31-bit gap
            # rank, strictly monotone in (cls, khi, klo, vid)
            self.rank_index = rk.RankIndex()
            self._rank_str_epoch = -1
        self.table = self._init_table(num_peers, capacity)
        self.capacity = capacity
        self.tick = 0
        self._clock = np.zeros(num_peers, dtype=np.int64)
        # scalar-put hot path reads/writes this LIST shadow (plain list
        # index ops beat np scalar indexing ~3x); the np array is
        # materialized at every vectorized boundary (_clock_sync_np)
        self._clock_list = [0] * num_peers
        self._pending: List[List[Tuple[int, int, int, int, int, int]]] = [
            [] for _ in range(num_peers)
        ]
        self._pending_bulk: List[Tuple[np.ndarray, ...]] = []
        # live-bridge fabric (models/bridge.py): ONE lock serializes every
        # bridge pump/flush/view query against this sim, and the stage
        # registry lets any pump drain EVERY attached bridge's staged
        # writes, so a sim with several bridges converges over all their
        # streams whichever handle flushes
        self._bridge_lock = threading.Lock()
        self._bridge_stages: List[Tuple[Any, int]] = []
        # scalar-put fast path: enabled until any hook or schema registers
        self._fast_put_ok = True
        # scalar-put fast-path memoization (see _put_scalar_fast)
        self._slot_cache: Dict[str, int] = {}
        self._enc_num_cache: Dict[Any, Tuple[int, int, int, int]] = {}
        self._enc_str_cache: Dict[str, Tuple[int, int, int, int]] = {}
        self._enc_str_epoch = -1
        self._subs: List[dict] = []
        # batch-ingress pipeline (SURVEY §7 stage 5): middleware hooks +
        # schema validation, both zero-cost until something registers
        self.validation = EngineValidation(self)
        self.hooks = EngineHooks(self)
        # frontier bookkeeping (ring/chain): per-column dirty flags [N]
        # known only between a completed convergence and the next untracked
        # mutation; None = unknown -> start all-dirty. The stripe loops'
        # seeds are derived from it (_frontier_seed), the column pass takes
        # it as it is
        self._frontier_dirty: Optional[np.ndarray] = None
        # the same marks by the column pass's 16-column group, kept beside
        # the columns so that a converge need not reduce them; read only
        # while _frontier_dirty is valid
        self._frontier_groups: Optional[np.ndarray] = None
        # (topology, the graph pass's reading of its neighbour matrix),
        # built on its first use (_graph_plan)
        self._graph_plan_of: Optional[Tuple[topo.Topology, pk.GraphPlan]] = None
        # the topology the marks last found every column settled under: the
        # graph pass passes every column after the topology changed (a
        # partition healed), since a column settled under another topology
        # need not be settled under this one
        self._settled_under: Optional[topo.Topology] = None
        self.stats = {
            "ops_enqueued": 0,
            "ops_applied": 0,
            "ops_rejected": 0,
            "gossip_rounds": 0,
            "windowed_rounds": 0,
            "merged_entries": 0,
            "steps": 0,
        }
        self.last_residual: Optional[int] = None

    # ------------------------------------------------------------ write path

    def put(self, peer: int, path: str, value: Any) -> bool:
        """Queue a local put at ``peer`` (applied on the next step). Object
        values decompose into leaves. Put hooks may veto or rewrite the put;
        on a schema-bound path the host validator checks it, with typed
        errors to the error handlers. Returns False iff the put was vetoed
        or rejected."""
        if self._fast_put_ok and type(value) is not dict:
            # hot scalar path: memoized path->slot and numeric
            # value->encoding, no hook/flatten machinery. The flag is
            # cleared for good by any hook or schema registration
            # (ingress.py _disable_fast_put). The common numeric-hit case
            # is inlined here; misses and other types take the helper
            enc = None
            t = type(value)
            if t is float or t is int:
                enc = self._enc_num_cache.get(value)
            if enc is not None:
                slot = self._slot_cache.get(path)
                if slot is not None:
                    clock = self._clock_list
                    c = clock[peer] + 1
                    clock[peer] = c
                    self._pending[peer].append((slot, *enc, c))
                    self.stats["ops_enqueued"] += 1
                    return True
            return self._put_scalar_fast(peer, path, value)
        if self.hooks.active:
            cont, path, value = self.hooks.run_put(peer, path, value)
            if not cont:
                return False
        if self.validation.active and not self.validation.check_put(path, value):
            return False
        leaves = list(flatten_value(path, value))
        if any(not leaf_path for leaf_path, _ in leaves):
            raise ValueError(
                "cannot put a scalar at the root path (empty leaf path)"
            )
        if len(leaves) > 4:
            # tree puts batch through the bulk machinery: one intern_batch
            # call + vectorized value encode instead of a Python loop per
            # leaf (outcome identical — enqueue order never affects the
            # converged state)
            from ..utils.encode import bulk_encode_values

            slots = self.host.intern_batch([p for p, _ in leaves])
            cls, khi, klo, vid = bulk_encode_values(
                self.host.values, [v for _, v in leaves]
            )
            self._enqueue_bulk(
                np.full(len(leaves), peer, dtype=np.int32),
                slots.astype(np.int32), cls, khi, klo, vid,
            )
        else:
            for leaf_path, leaf_value in leaves:
                slot = self.host.intern_path(leaf_path)
                cls, khi, klo, vid = self.host.encode_value(leaf_value)
                c = self._clock_list[peer] + 1
                self._clock_list[peer] = c
                self._pending[peer].append((slot, cls, khi, klo, vid, c))
                self.stats["ops_enqueued"] += 1
        self.hooks.queue_after_put(peer, path, value)
        return True

    # scalar-fast-path cache bound: keeps pathological workloads (e.g.
    # unbounded-distinct values) from growing the dicts without limit; a
    # clear only costs re-encoding
    _FAST_CACHE_MAX = 1 << 20

    def _put_scalar_fast(self, peer: int, path: str, value: Any) -> bool:
        """Hot scalar ``put``: no hooks, no validation, non-dict value.

        Two memoizations carry the speedup: path -> slot (the interner is
        append-only, so slots are stable), and numeric value -> encoding
        (number order keys never re-rank). String encodings re-rank when
        the order-statistic tree rebalances, so the string cache is
        validated against the interner epoch and flushed on change."""
        if not path:
            raise ValueError(
                "cannot put a scalar at the root path (empty leaf path)"
            )
        slot = self._slot_cache.get(path)
        if slot is None:
            slot = self.host.intern_path(path)
            if len(self._slot_cache) >= self._FAST_CACHE_MAX:
                self._slot_cache.clear()
            self._slot_cache[path] = slot
        t = type(value)
        if (t is float or t is int) and value == value:
            enc = self._enc_num_cache.get(value)
            if enc is None:
                enc = self.host.encode_value(value)
                if len(self._enc_num_cache) >= self._FAST_CACHE_MAX:
                    self._enc_num_cache.clear()
                self._enc_num_cache[value] = enc
        elif t is str:
            epoch = self.host.values.epoch
            if epoch != self._enc_str_epoch:
                self._enc_str_cache.clear()
                self._enc_str_epoch = epoch
            enc = self._enc_str_cache.get(value)
            if enc is None:
                enc = self.host.encode_value(value)
                if self.host.values.epoch != epoch:
                    # this very insert rebalanced: ranks just moved
                    self._enc_str_cache.clear()
                    self._enc_str_epoch = self.host.values.epoch
                if len(self._enc_str_cache) >= self._FAST_CACHE_MAX:
                    self._enc_str_cache.clear()
                self._enc_str_cache[value] = enc
        else:
            enc = self.host.encode_value(value)
        clock = self._clock_list
        c = clock[peer] + 1
        clock[peer] = c
        self._pending[peer].append((slot, *enc, c))
        self.stats["ops_enqueued"] += 1
        return True

    def put_bulk(self, peers, paths, values) -> None:
        """Vectorized ingestion: enqueue many scalar puts at once.

        ``peers`` — int array [K], or a single int to load every row into
        one peer; ``values`` — numeric array [K] (the fast path) or any list
        of leaf values; ``paths`` — list of K path strings, or an int32
        array of pre-interned slot ids (see ``intern_path``), the raw
        device feed, which skips every host hook by design.

        With hooks or schemas registered: put hooks run per row, the strict
        schema constraints the device mask cannot express drop rows here
        (with typed errors), and afterPut/"write" delivery is queued for the
        rows that pass; the type, range and enum veto runs on the device
        at the next apply (see ``_ingress``)."""
        with observe.span("put_bulk"):
            self._put_bulk(peers, paths, values)

    def _put_bulk(self, peers, paths, values) -> None:
        peers = np.asarray(peers, dtype=np.int32)
        if peers.ndim == 0:
            peers = np.full(len(paths), int(peers), dtype=np.int32)
        k = len(peers)
        if k == 0:
            return
        pre_interned = isinstance(paths, np.ndarray) and paths.dtype.kind == "i"
        if self.hooks._put and not pre_interned:
            # host put hooks see bulk rows too (veto/mutate parity with
            # scalar puts); this per-row pass runs only while hooks are
            # registered
            kept_p, kept_paths, kept_vals = [], [], []
            vals_seq = values.tolist() if isinstance(values, np.ndarray) else values
            for p, path, value in zip(peers, paths, vals_seq):
                cont, path, value = self.hooks.run_put(int(p), path, value)
                if cont:
                    kept_p.append(int(p))
                    kept_paths.append(path)
                    kept_vals.append(value)
            if not kept_p:
                return
            peers = np.asarray(kept_p, dtype=np.int32)
            paths, values = kept_paths, kept_vals
            k = len(peers)
        if pre_interned:
            slots = paths.astype(np.int32)
        else:
            with observe.span("put_bulk.intern"):
                slots = self.host.intern_batch(paths)
        # the numeric fast path requires an EXPLICIT numeric ndarray:
        # np.asarray on a mixed list would silently coerce bools (and
        # mixed strings) to numbers, diverging from scalar-put encoding
        numeric = isinstance(values, np.ndarray) and values.dtype.kind in "ifu"
        with observe.span("put_bulk.encode"):
            if numeric:
                from ..utils.encode import bulk_encode_numbers

                raw_vals: Any = values
                cls, khi, klo, vid = bulk_encode_numbers(self.host.values, values)
            else:
                from ..utils.encode import bulk_encode_values

                raw_vals = (
                    values.tolist() if isinstance(values, np.ndarray) else list(values)
                )
                cls, khi, klo, vid = bulk_encode_values(self.host.values, raw_vals)

        # strict schema constraints the device mask can't express (integer
        # integralness, boolean identity, string/array length) drop here,
        # while the raw values are still in hand; the type/range/enum veto
        # stays on the device
        if self.validation.active:
            drop = self.validation.strict_bulk_mask(slots, raw_vals)
            if drop is not None and drop.any():
                for i in np.nonzero(drop)[0]:
                    path = self.host.paths.path(int(slots[i]))
                    val = float(raw_vals[i]) if numeric else raw_vals[i]
                    # re-run the host checker for the exact typed error
                    self.validation.host.check_write(path, val)
                keep = ~drop
                peers, slots, cls, khi, klo, vid = (
                    a[keep] for a in (peers, slots, cls, khi, klo, vid)
                )
                raw_vals = (
                    raw_vals[keep] if numeric
                    else [v for v, kp in zip(raw_vals, keep) if kp]
                )
                self.stats["ops_rejected"] += int(drop.sum())
                k = len(peers)
                if k == 0:
                    return

        # afterPut hooks + "write" events fire for accepted rows, as for
        # scalar puts (merge losers fire too: the reference's
        # afterPut-after-setData contract, bullet-middleware.js:112-131).
        # With schemas bound each row re-checks silently, so rows the
        # device mask will veto don't claim a write happened (the device
        # path owns their typed errors). O(K) Python, only while afterPut
        # hooks or listeners are registered.
        if not pre_interned and (self.hooks._after_put or self.hooks._events):
            check = self.validation.host.check_write if self.validation.active else None
            upaths = {int(s): self.host.paths.path(int(s)) for s in np.unique(slots)}
            for i in range(k):
                path = upaths[int(slots[i])]
                val = float(raw_vals[i]) if numeric else raw_vals[i]
                if check is not None and not check(path, val, report=False):
                    continue
                self.hooks.queue_after_put(int(peers[i]), path, val)

        with observe.span("put_bulk.enqueue"):
            self._enqueue_bulk(peers, slots, cls, khi, klo, vid)
        if self.layout in RANK_FAMILY:
            # rank the new values now, while the batch is hot; a respread's
            # device re-key waits for the next _sync_rank_index
            with observe.span("put_bulk.rank_insert") as sp:
                epoch = self.rank_index.epoch
                self._stage_rank_inserts()
                sp.set(respread=int(self.rank_index.epoch != epoch))

    def _enqueue_bulk(self, peers, slots, cls, khi, klo, vid) -> None:
        """Stamp per-op Lamport counters (clock[peer] + within-batch
        sequence) and queue one bulk chunk — the single enqueue point shared
        by ``put_bulk`` and batched tree ``put``s."""
        seq, counts = _group_positions(peers, self.num_peers)
        self._clock_sync_np()
        ctr = (self._clock[peers] + seq + 1).astype(np.int32)
        self._clock += counts
        self._clock_list = self._clock.tolist()
        self._pending_bulk.append((peers, slots, cls, khi, klo, vid, ctr))
        self.stats["ops_enqueued"] += len(peers)

    def _clock_sync_np(self) -> None:
        np.copyto(self._clock, self._clock_list)

    def _clock_snapshot(self) -> np.ndarray:
        self._clock_sync_np()
        return self._clock.copy()

    def intern_path(self, path: str) -> int:
        """Pre-intern a path for slot-id based ``put_bulk`` ingestion."""
        return self.host.intern_path(path)

    def remove(self, peer: int, path: str) -> bool:
        """Put null at ``path`` and every known descendant leaf. In
        reference mode null loses to greater scalars; lww deletes. Delete
        hooks may veto (bullet-middleware.js:137-186)."""
        if self.hooks.active and not self.hooks.run_delete(peer, path):
            return False
        pid = self.host.intern_path(path)
        self.put(peer, path, None)
        for slot in self.host.leaf_slots_under(pid):
            self.put(peer, self.host.paths.path(slot), None)
        if self.hooks.active:
            self.hooks.fire_after_delete(peer, path)
        return True

    # ----------------------------------------------------------------- step

    def _drain_ops(self) -> Optional[List[np.ndarray]]:
        """Pack queued ops (scalar puts + bulk batches) into the six dense
        [P, B] int32 numpy arrays of an OpBatch (slot first) via numpy
        scatter."""
        peer_list, field_cols = [], [[] for _ in range(6)]
        for p, ops in enumerate(self._pending):
            for op in ops:
                peer_list.append(p)
                for f in range(6):
                    field_cols[f].append(op[f])
            ops.clear()
        chunks_peers = []
        chunks_fields = [[] for _ in range(6)]
        if peer_list:
            chunks_peers.append(np.asarray(peer_list, dtype=np.int32))
            for f in range(6):
                chunks_fields[f].append(np.asarray(field_cols[f], dtype=np.int32))
        for bulk in self._pending_bulk:
            chunks_peers.append(bulk[0])
            for f in range(6):
                chunks_fields[f].append(bulk[f + 1])
        self._pending_bulk.clear()
        if not chunks_peers:
            return None

        peers = np.concatenate(chunks_peers)
        flat = [np.concatenate(c) for c in chunks_fields]
        bpos, counts = _group_positions(peers, self.num_peers)
        # pow2 batch width, as the reference pads (padded entries are
        # cls 0 — they never win)
        batch = max(8, 1 << max(int(counts.max()) - 1, 1).bit_length())

        fields = [np.zeros((self.num_peers, batch), dtype=np.int32) for _ in range(6)]
        for f in range(6):
            fields[f][peers, bpos] = flat[f]
        # padded entries are slot 0 / cls 0: they never win, and dirty
        # column 0 conservatively in frontier seeding
        return fields

    def _drain_flat(self):
        """Queued ops as flat numpy arrays (peer, slot, cls, khi, klo, vid) —
        the packed-layout ingestion shape (no dense [P, B] padding)."""
        chunks = []
        for p, ops in enumerate(self._pending):
            if ops:
                a = np.asarray(ops, dtype=np.int32)  # rows: slot..ctr
                chunks.append(
                    (np.full(len(ops), p, dtype=np.int32),
                     a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4])
                )
                ops.clear()
        for bulk in self._pending_bulk:
            peers, slots, cls, khi, klo, vid, _ctr = bulk
            chunks.append((peers, slots, cls, khi, klo, vid))
        self._pending_bulk.clear()
        if not chunks:
            return None
        return tuple(np.concatenate([c[i] for c in chunks]) for i in range(6))

    def _init_table(self, num_peers: int, capacity: int):
        init = {"packed": pk.init_packed, "rank": rk.init_rank, "rank1": rk.init_rank1}
        init = init.get(self.layout, init_table)
        if self.mesh is not None:
            rows = num_peers // len(self.mesh)
            return ShardedTable([init(rows, capacity, d) if self.mesh.owns(i) else None
                                 for i, d in enumerate(self.mesh)], self.mesh)
        return init(num_peers, capacity, self.device)

    def _shape(self) -> Tuple[int, int]:
        """(P, N) of the table, sharded or not."""
        if isinstance(self.table, ShardedTable):
            return self.table.shape
        return tuple(self.table[0].shape)

    def _ensure_capacity(self) -> None:
        needed = len(self.host.paths)
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        self._frontier_dirty = None  # column count changes with capacity
        if isinstance(self.table, ShardedTable):
            self.table = self.table.map(lambda t: _grown(t, new_cap))  # each shard
        else:
            self.table = _grown(self.table, new_cap)
        self.capacity = new_cap

    def _maybe_rekey(self) -> None:
        if not self.host.needs_rekey:
            return
        if self.layout in RANK_FAMILY:
            # a string-rank rebalance moves khi/klo bits but keeps the value
            # order, and a rank table stores no key bits: the device state is
            # already right. The RankIndex's stored keys refresh through the
            # interner epoch in _stage_rank_inserts.
            self.host.needs_rekey = False
            return
        maps = [
            torch.from_numpy(np.asarray(m, dtype=np.int32)).to(self.device)
            for m in self.host.key_tables()
        ]
        rekey = _rekey_packed if self.layout == "packed" else _rekey
        self.table = self._per_shard(lambda t: rekey(t, *(m.to(t[0].device) for m in maps)))
        self.host.needs_rekey = False

    def _stage_rank_inserts(self) -> None:
        """Rank-index maintenance without the device re-key: refresh the
        stored key columns after a string rebalance and rank the newly
        interned vids. A respread's re-key waits for _sync_rank_index."""
        vals = self.host.values
        if self._rank_str_epoch != vals.epoch:
            self.rank_index.refresh_keys(*self.host.key_tables())
            self._rank_str_epoch = vals.epoch
        n_ranked = len(self.rank_index)
        if len(vals) > n_ranked:
            cls_map, khi_map, klo_map = self.host.key_tables()
            new = np.arange(n_ranked, len(vals))
            self.rank_index.insert_batch(new, cls_map[new], khi_map[new], klo_map[new])

    def _device_lut(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device or self.device)

    def _sync_rank_index(self) -> None:
        """Bring the RankIndex up to date with the interner and, if a gap
        exhausted and the rank space respread, re-gather the device table's
        ranks so ops and table compare under one map version: through cv's
        vid (rank), or by decoding the stale ranks through the pre-respread
        inverse (rank1, ``RankIndex.prev_inverse``)."""
        self._stage_rank_inserts()
        if not self.rank_index.needs_rekey:
            return
        with observe.span("apply.respread"):
            if self.layout == "rank1":
                self._rekey_rank1(*self.rank_index.prev_inverse)
            else:
                self._rekey_rank()
        self.rank_index.needs_rekey = False

    def _per_shard(self, fn: Callable):
        """``fn`` applied to the table, or to each shard of a sharded one."""
        if isinstance(self.table, ShardedTable):
            return self.table.map(fn)
        return fn(self.table)

    def _rekey_rank(self) -> None:
        """Re-gather a rank table's ranks from cv's vid, per shard."""
        self._regather_ranks(rk.rekey_rank, lambda: [self.rank_index.rank_map()])

    def _rekey_rank1(self, old_sranks: np.ndarray, old_svids: np.ndarray) -> None:
        """Re-gather a rank1 table's ranks through an older epoch's inverse
        (sorted ranks, their vids), per shard."""
        self._regather_ranks(
            rk.rekey_rank1, lambda: [old_sranks, old_svids, self.rank_index.rank_map()])

    def _regather_ranks(self, regather: Callable, host_luts: Callable) -> None:
        """``regather(shard, *luts)`` on every shard, the host LUTs that
        ``host_luts()`` builds first copied to every shard's device."""
        with observe.span("apply.respread.luts"):
            luts = host_luts()
            if isinstance(self.table, ShardedTable):
                devices = {s[0].device for _, s in self.table.local()}
            else:
                devices = {self.table[0].device}
            on = {d: [self._device_lut(a, d) for a in luts] for d in devices}
        with observe.span("apply.respread.regather"):
            self.table = self._per_shard(lambda t: regather(t, *on[t[0].device]))

    def _mark_dirty(self, slots: np.ndarray) -> None:
        """Frontier bookkeeping: the columns ``slots`` need work."""
        if self._frontier_dirty is None:
            return
        if self._frontier_tile() and len(self._frontier_dirty) == self._shape()[1]:
            self._frontier_dirty[slots] = True
            self._frontier_groups[slots // pk.COLUMN_GROUP] = True
        else:
            self._frontier_dirty = None

    def _apply_pending(self) -> int:
        """Drain + apply, layout-dispatched; returns the applied count. An
        apply that drained ops is the span ``apply``."""
        if self.layout in PACKED_FAMILY:
            drained, apply = self._drain_flat(), self._apply_flat
        else:
            drained, apply = self._drain_ops(), self._apply_dense
        if drained is None:
            return 0
        with observe.span("apply"):
            return apply(drained)

    def _apply_dense(self, drained: List[np.ndarray]) -> int:
        """Apply the drained dense [P, B] op fields."""
        if self.hooks._traced_put:
            self._frontier_dirty = None  # transforms may move slots
        else:
            self._mark_dirty(drained[0])
        ingressed = None
        if self.hooks._traced_put or self.validation.active:
            # ingress sees the whole batch on the sim's device (a mesh's
            # first), before it is split by shard
            with observe.span("apply.ingress"):
                ingressed = self._ingress(
                    OpBatch(*(torch.from_numpy(f).to(self.device) for f in drained)))

        def upload(rows: slice, device) -> OpBatch:
            if ingressed is not None:
                return OpBatch(*(f[rows].to(device) for f in ingressed))
            return OpBatch(*(torch.from_numpy(f[rows]).to(device) for f in drained))

        if isinstance(self.table, ShardedTable):
            # each shard applies its own peers' ops, as the reference
            # shards the op batch by peer; the count is summed over the
            # processes
            b, applied = self.table.rows, 0
            shards = list(self.table.shards)
            for i, shard in self.table.local():
                dev = self.table.mesh[i]
                shards[i], a = apply_ops(shard, upload(slice(i * b, (i + 1) * b), dev),
                                         self.tick, mode=self.mode, first_peer=i * b)
                applied += int(a)
            self.table = ShardedTable(shards, self.table.mesh)
            return all_sum_int(self.table.mesh, applied)
        with observe.span("apply.upload"):
            ops = upload(slice(None), self.device)
        with observe.span("apply.launch"):
            self.table, applied = apply_ops(self.table, ops, self.tick, mode=self.mode)
            return int(applied)

    def _apply_flat(self, flat) -> int:
        """Packed-family apply of the drained flat ops: flat ingress (traced
        transforms + the validation veto, on the device), host lattice
        pre-reduction per (peer, slot), then ONE upload of the [2 + nf, K]
        winners and one flat apply (the kernel on the card) — no dense
        batch; on a mesh, one of each per shard, with the winners of its
        peers at their local rows. The rank layouts stamp each op with its
        value's rank first. Unlike the reference, ops are never staged on
        the device at put time (that hid a TPU link's latency)."""
        if len(self.host.values) > pk.MAX_VID:
            raise RuntimeError(
                f"{self.layout} layout caps distinct values at 2^28; interner "
                f"holds {len(self.host.values)} — use layout='dense'"
            )
        if self.hooks._traced_put or (
            self.validation.active and self.validation.rules() is not None
        ):
            # ingress before the reduction: a vetoed op must not hide the
            # valid op it would have beaten, and rank stamping must see the
            # vids the transforms wrote
            with observe.span("apply.ingress"):
                flat = self._ingress_flat(flat)
        if self.layout in RANK_FAMILY:
            # rank stamping sees every new vid, and a device table coherent
            # with the same map version
            with observe.span("apply.rank_sync"):
                self._sync_rank_index()
        with observe.span("apply.reduce"):
            if self.layout in RANK_FAMILY:
                peer, slot, cls, _khi, _klo, vid = flat
                rank = self.rank_index.rank_map()[vid]
                cv = ((cls.astype(np.int64) << pk.CV_SHIFT) | vid).astype(np.int32)
                reduced = rk.reduce_flat_ops_rank(peer, slot, rank, cv)
                if reduced is not None and self.layout == "rank1":
                    # the rank decides the winner alone; rank1 stores no cv
                    reduced = reduced[:3]
            else:
                reduced = pk.reduce_flat_ops(*flat)
            if reduced is None:
                return 0
            self._mark_dirty(reduced[1])
            ops = np.stack(reduced)
        if isinstance(self.table, ShardedTable):
            # the winners are sorted by peer: each shard's are one run; the
            # count is summed over the processes
            b, applied = self.table.rows, 0
            cuts = np.searchsorted(ops[0], np.arange(len(self.table.shards) + 1) * b)
            for i, shard in self.table.local():
                if cuts[i] == cuts[i + 1]:
                    continue
                local = ops[:, cuts[i]:cuts[i + 1]].copy()
                local[0] -= i * b
                dev = self.table.mesh[i]
                applied += int(pk.apply_flat_packed(shard, torch.from_numpy(local).to(dev))[1])
            return all_sum_int(self.table.mesh, applied)
        # one flat apply for the whole family: the wrapper dispatches on nf
        with observe.span("apply.upload"):
            ops = torch.from_numpy(ops).to(self.device)
        with observe.span("apply.launch"):
            self.table, applied = pk.apply_flat_packed(self.table, ops)
            return int(applied)

    def warm_apply_buckets(self, max_ops: int = 1 << 16) -> int:
        """Serving warm-up: one apply of an all-padding batch (see
        ``_pad_flat_ops``) for every power-of-two bucket from 64 up to
        ``max_ops``, on every shard of this process, so a live mirror's
        first queries find the kernel library loaded and the allocator's
        blocks sized (the
        reference compiles one program a bucket here; the port compiles
        nothing per batch size). Nothing lands: padding lies outside the
        table, and a launch that applies an op raises. Packed family only
        (the serving layouts); returns the number of buckets, 0 on dense."""
        if self.layout not in PACKED_FAMILY:
            return 0
        self._sync_device_state()
        if isinstance(self.table, ShardedTable):
            shards = [s for _, s in self.table.local()]
        else:
            shards = [self.table]
        rows, n = shards[0][0].shape
        nf = len(shards[0])
        empty = tuple(np.zeros(0, dtype=np.int32) for _ in range(2 + nf))
        warmed, bucket = 0, 64
        while bucket <= max_ops:
            ops = np.stack(_pad_flat_ops(empty, rows, n, min_bucket=bucket))
            for shard in shards:
                dev_ops = torch.from_numpy(ops).to(shard[0].device)
                _, applied = pk.apply_flat_packed(shard, dev_ops)
                if int(applied) != 0:
                    raise RuntimeError(f"warm_apply_buckets: padding landed ({int(applied)} ops)")
            warmed += 1
            bucket <<= 1
        return warmed

    def _ingress(self, ops: OpBatch) -> OpBatch:
        """Batch-ingress pipeline between drain and apply (SURVEY §7 stage
        5), on the ops' device: the traced put transforms, then the compiled
        schema rules veto invalid ops (cls=0 ⇒ guaranteed loser); rejected
        ops produce host-side typed errors."""
        transforms = tuple(self.hooks._traced_put)
        rules = self.validation.rules() if self.validation.active else None
        if not transforms and rules is None:
            return ops
        struct = self.host.struct(ops.slot.device)
        if transforms:
            ops = traced_pipeline(transforms)(ops, struct)
        if rules is not None:
            invalid = invalid_op_mask(ops, struct, rules)
            rejected = self.validation.report_rejections(ops, invalid)
            if rejected:
                ops = veto_ops(ops, invalid)
                self.stats["ops_rejected"] += rejected
        return ops

    def _ingress_flat(self, flat):
        """``_ingress`` over the drained flat ops (peer, slot, cls, khi,
        klo, vid), numpy [K] each: one upload of the five op fields to the
        sim's device (ctr zero, as the reference's flat batch), and back
        the fields the pipeline may have changed — all five after a
        transform, else cls, and only if an op was vetoed."""
        peer = flat[0]
        up = torch.from_numpy(np.stack(flat[1:])).to(self.device)
        ops = OpBatch(*up, ctr=torch.zeros_like(up[0]))
        out = self._ingress(ops)
        if self.hooks._traced_put:
            back = torch.stack([f.to(torch.int32) for f in out[:5]]).cpu().numpy()
            return (peer, *back)
        if out.cls is ops.cls:
            return flat
        return (peer, flat[1], out.cls.cpu().numpy(), *flat[3:])

    def _frontier_tile(self) -> int:
        """Stripe width the frontier convergence path would use at the
        current shape (the port's own width); 0 = no frontier runs and
        dirty-column bookkeeping is pointless. A lean or sharded sim runs it
        exactly where the reference does (a lean sim's route decides its
        bits); a data mesh never does (a packed one keeps the bookkeeping,
        as the reference)."""
        p, n = self._shape()
        tile_n = pk.frontier_tile_n(n)
        if self.layout in PACKED_FAMILY:
            if self.mesh is not None and self.use_shard_map:
                return tile_n if pk.frontier_available_sharded(p, n, len(self.mesh)) else 0
            return tile_n
        if self.mesh is not None:
            spmd = self.use_shard_map and dense_frontier_available_sharded(
                p, n, len(self.mesh), self.lean_gossip)
            return tile_n if spmd else 0
        if self.lean_gossip and not dense_frontier_available(p, n, True):
            return 0
        return tile_n

    def _lean_rounds(self) -> bool:
        """Lean gossip on the kernel route: the rounds take the lean round
        where the reference's lean kernel would (see gossip.lean_round_applies)."""
        return self.lean_gossip and self.use_kernels

    def _round(self, table):
        """One gossip round of ``table`` over the topology: the packed
        family's (the explicit exchange on a mesh, with the unsharded
        round's bits and counts), the dense explicit exchange on a mesh
        (full metadata with use_shard_map, as the reference's shard_map
        rounds), else the single-device round. Returns (table, changed)."""
        if self.layout in PACKED_FAMILY:
            return pk.gossip_round_packed(table, self.topology)
        if self.mesh is not None:
            if self.use_shard_map:
                return shardmap_round(table, self.topology, self.mode)
            return data_mesh_round(table, self.topology, self.mode, self._lean_rounds())
        return gossip_round(table, self.topology, self.mode, self._lean_rounds())

    def step(self, rounds: int = 1) -> int:
        """Apply queued ops, run ``rounds`` gossip rounds; returns residual
        (entries changed in the last round)."""
        with observe.span("step"):
            self._ensure_capacity()
            self._maybe_rekey()
            self.tick += 1
            self.stats["ops_applied"] += self._apply_pending()
            self.hooks.fire_after_puts()
            residual = 0
            if rounds and self._graph_pass_applies():
                # every round's count; the rounds after the pass's last
                # change change nothing
                _, _, counts = self._graph_rounds(rounds)
                residual = counts[-1] if len(counts) == rounds else 0
                self.stats["gossip_rounds"] += rounds
                self.stats["merged_entries"] += sum(counts)
            elif rounds:
                self._frontier_dirty = None  # untracked gossip advances columns
                for _ in range(rounds):
                    self.table, changed = self._round(self.table)
                    residual = int(changed)
                    self.stats["gossip_rounds"] += 1
                    self.stats["merged_entries"] += residual
            self.stats["steps"] += 1
            self.last_residual = residual if rounds else None
            self._sync_clocks()
            self._fire_subscriptions()
            return residual

    def _fast_forward_route(self) -> str:
        """Which implementation fast_forward uses for this sim state:
        "spmd" (a packed-family ring or chain sim on a mesh: one window per
        exchange of slabs as deep as a shard, ``ring_window_shardmap_packed``),
        "frontier" (the compacting frontier loop with max_rounds = k: a
        packed sim on the card whose dirty-column tracking is valid, so the
        jump is not blind), "window" (every other packed-family ring or
        chain sim: the window-join kernel on the card, its plain version on
        the CPU) or "step" (dense layouts and other topologies). The
        reference's "pallas", "halo_window" and "xla" routes all become
        "window": a column-owning kernel has no VMEM budget to route
        around; its "xla" route on a data mesh becomes "spmd"."""
        if self.layout not in PACKED_FAMILY or self.topology.kind not in ("ring", "chain"):
            return "step"
        if self.mesh is not None:
            return "spmd"
        if self._card_routes() and self.layout == "packed" and self._frontier_tracking_valid():
            return "frontier"
        return "window"

    def fast_forward(self, rounds: int) -> int:
        """Advance exactly ``rounds`` gossip rounds, bit-identical to
        ``step(rounds)`` (same table, same returned last-round residual),
        computed as radius-m window joins in O(log m) 3-way joins per pass
        instead of m sequential rounds: the merge is an idempotent lattice
        join, so m rounds equal one radius-m window.

        A window pass covers min(left, P + 1) rounds: P + 1 rounds reach
        the fixed point of any ring or chain of P peers (a chain's all-zero
        ends are P rows from its far edge), so a longer pass could change
        nothing more; on a mesh min(left, b), b the rows of a shard (its
        slabs come from one neighbour). A pass whose round-m residual is 0
        has reached the fixed point; the remaining rounds are no-ops and are
        skipped, and every column is marked clean. The "frontier" route (see
        ``_fast_forward_route``) runs the fused frontier loop with
        ``max_rounds = rounds`` instead.

        Accounting: ``stats["gossip_rounds"]`` and
        ``stats["windowed_rounds"]`` grow by ``rounds``; intermediate
        rounds are never materialized, so ``merged_entries`` grows by the
        final round's residual only. Dense layouts and other topologies
        delegate to ``step(rounds)``."""
        route = self._fast_forward_route()
        if rounds <= 0 or route == "step":
            return self.step(rounds)
        self._ensure_capacity()
        self._maybe_rekey()
        self.tick += 1
        self.stats["ops_applied"] += self._apply_pending()
        self.hooks.fire_after_puts()
        # re-resolve: the apply refreshed the dirty-column tracking
        route = self._fast_forward_route()
        wrap = self.topology.kind == "ring"
        p, n = self._shape()
        if route == "frontier":
            tile_n = self._frontier_tile()
            t_total = n // tile_n
            self.table, rounds_exec, last_changed = pk.gossip_frontier_packed(
                self.table, self._frontier_seed(t_total), wrap, rounds,
                fuse=pk.STRIPE_FUSE, tile_n=tile_n,
            )
            self._finish_frontier(rounds_exec, last_changed, rounds)
            residual = int(last_changed)
        else:
            self._frontier_dirty = None  # untracked gossip advances columns
            left, residual = rounds, 0
            while left:
                if route == "spmd":
                    m = min(left, self.table.rows)
                    self.table, changed = ring_window_shardmap_packed(self.table, wrap, m)
                else:
                    m = min(left, p + 1)
                    self.table, changed = pk.ring_window_packed(self.table, wrap, m)
                left -= m
                residual = int(changed)
                if residual == 0:
                    # fixed point: the table is settled until new ops land
                    self._frontier_settled()
                    break
        self.stats["gossip_rounds"] += rounds
        self.stats["windowed_rounds"] += rounds
        self.stats["merged_entries"] += residual
        self.stats["steps"] += 1
        self.last_residual = residual
        self._sync_clocks()
        self._fire_subscriptions()
        return residual

    def run_until_converged(self, max_rounds: Optional[int] = None) -> int:
        """Apply pending ops then gossip to the fixed point. Returns the
        classic round count (the first round that changed nothing, or the
        cap)."""
        with observe.span("converge"):
            self._ensure_capacity()
            self._maybe_rekey()
            self.tick += 1
            self.stats["ops_applied"] += self._apply_pending()
            self.hooks.fire_after_puts()
            if max_rounds is None:
                max_rounds = max(2 * self.topology.diameter + 2, 4)
            _, runner = self._convergence_strategy()
            return runner(max_rounds)

    # -- convergence strategy dispatch (see CONVERGENCE_STRATEGIES) --------

    def _convergence_cell(self) -> ConvergenceCell:
        return ConvergenceCell(
            layout=self.layout,
            ring_chain=self.topology.kind in ("ring", "chain"),
            frontier=self._frontier_tile() > 0,
            spmd=self.mesh is not None and self.use_shard_map,
            data_mesh=self.mesh is not None,
            kernels=self.use_kernels,
        )

    def _convergence_strategy(self) -> Tuple[str, Callable[[int], int]]:
        """(row name, runner) for the current sim state — the single place
        run_until_converged picks a loop implementation."""
        cell = self._convergence_cell()
        for name, pred, method in CONVERGENCE_STRATEGIES:
            if pred(cell):
                return name, getattr(self, method)
        raise AssertionError("unreachable: the last row matches every cell")

    def _card_routes(self) -> bool:
        """Whether the sim takes the card's fused routes: STRIPE_FUSE rounds
        a frontier step (dense and packed family), HALO_FUSE rounds or an
        m-round window an exchange on a mesh, and the tracked packed
        ``fast_forward`` on the frontier. On the CPU the same loops run
        unfused, as the reference runs interpret mode; either way the
        tables, round counts and residuals are the same."""
        return self.device.type == "cuda"

    def _frontier_tracking_valid(self) -> bool:
        """True when the dirty-column tracking is live for the current
        shape: a fast_forward jump is then not blind."""
        d = self._frontier_dirty
        return d is not None and self._frontier_tile() > 0 and len(d) == self._shape()[1]

    def _frontier_columns(self) -> Optional[np.ndarray]:
        """The tracked dirty columns when valid, else None (all dirty)."""
        return self._frontier_dirty if self._frontier_tracking_valid() else None

    def _frontier_seed(self, t_total: int) -> torch.Tensor:
        """Dirty-stripe seed for a frontier loop: the stripes that hold a
        tracked dirty column when the tracking is valid (only stripes
        touched since the last completed convergence need work), else
        all-dirty."""
        cols = self._frontier_columns()
        if cols is None:
            return torch.ones(t_total, dtype=torch.bool, device=self.device)
        # 8 columns a word: a stripe (a multiple of 32 columns) is whole words
        stripes = cols.view(np.uint64).reshape(t_total, -1).any(1)
        return torch.from_numpy(stripes).to(self.device)

    def _frontier_settled(self) -> None:
        """A true fixed point: every column is settled until new ops land."""
        if self._frontier_tile():
            n = self._shape()[1]
            self._frontier_dirty = np.zeros(n, dtype=bool)
            self._frontier_groups = np.zeros(n // pk.COLUMN_GROUP, dtype=bool)
            self._settled_under = self.topology

    def _finish_frontier(self, rounds, final_changed, max_rounds):
        if rounds < max_rounds or final_changed == 0:
            self._frontier_settled()
        else:
            self._frontier_dirty = None  # cutoff: tracking is stale

    def _finish_converge(self, rounds, final_changed) -> int:
        with observe.span("converge.finish"):
            rounds = int(rounds)
            self.stats["gossip_rounds"] += rounds
            self.stats["steps"] += 1
            # honest residual: 0 only if the loop actually reached the fixed
            # point; nonzero when max_rounds cut it off mid-convergence
            self.last_residual = int(final_changed)
            self._sync_clocks()
            self._fire_subscriptions()
            return rounds

    def _column_pass_applies(self, max_rounds: int) -> bool:
        """Whether a packed-family ring or chain converge takes the column
        pass: on the card, where no cap can cut it short (max_rounds above
        the diameter, which bounds every row's distance to its column's
        join, and above 1, which a lone row of a chain may take from its
        ends), at a shape whose 16-column groups of one shard's rows (all
        rows where the table is not sharded) fit a block."""
        p, n = self._shape()
        sharded = isinstance(self.table, ShardedTable)
        rows = p // len(self.mesh) if sharded else p
        nf = len(self.table.first if sharded else self.table)
        return (self._card_routes() and max_rounds > max(self.topology.diameter, 1)
                and pk.column_pass_fits(rows, n, nf))

    def _column_pass_groups(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """(dirty columns, their 16-column groups' ids) for the column
        pass, or (None, None) where the tracking is stale (every column)."""
        cols = self._frontier_columns()
        return cols, None if cols is None else np.flatnonzero(self._frontier_groups)

    def _converge_frontier_local(self, max_rounds: int) -> int:
        """Packed-family convergence of a ring or chain. On the card an
        uncapped converge settles the dirty columns in one column pass (the
        frontier loop's table, round count and residual); a capped one runs
        the compacting frontier loop, STRIPE_FUSE rounds fused per kernel
        step, with the exact classic round count rebuilt on the host. On the
        CPU the frontier loop's plain version runs unfused."""
        wrap = self.topology.kind == "ring"
        if self._column_pass_applies(max_rounds):
            cols, groups = self._column_pass_groups()
            self.table, rounds, final_changed = pk.gossip_columns_packed(
                self.table, cols, wrap, groups)
        else:
            tile_n = self._frontier_tile()
            t_total = self.table[0].shape[1] // tile_n
            fuse = pk.STRIPE_FUSE if self._card_routes() else 1
            self.table, rounds, final_changed = pk.gossip_frontier_packed(
                self.table, self._frontier_seed(t_total), wrap, max_rounds, fuse=fuse,
                tile_n=tile_n,
            )
        self._finish_frontier(rounds, final_changed, max_rounds)
        return self._finish_converge(rounds, final_changed)

    def _converge_frontier_spmd(self, max_rounds: int) -> int:
        """The packed family's frontier on a mesh. On the card an uncapped
        converge whose shards' 16-column groups fit a block settles the
        dirty columns in one column pass a shard about one gather of their
        summaries (``gossip_columns_shardmap_packed``: the frontier's table,
        round count and residual); otherwise per-shard frontier steps run
        between boundary exchanges, the shards' results agreed and folded.
        On the card each exchange of m-row slabs buys an m-round window (m
        of the reference's ``window_frontier_params``; HALO_FUSE = 8 rounds
        where the shards are too small for a window), with the exact
        classic round count rebuilt on the host; on the CPU it runs
        unfused, as the reference's interpret mode does."""
        p, n = self._shape()
        wrap = self.topology.kind == "ring"
        if self._column_pass_applies(max_rounds):
            cols, groups = self._column_pass_groups()
            self.table, rounds, final_changed = gossip_columns_shardmap_packed(
                self.table, cols, wrap, groups)
        else:
            tile_n = self._frontier_tile()
            window = fuse = 1
            if self._card_routes():
                window = pk.window_frontier_depth(p // len(self.mesh), n)
                fuse = 1 if window else HALO_FUSE
            self.table, rounds, final_changed = gossip_frontier_shardmap_packed(
                self.table, self._frontier_seed(n // tile_n), wrap, max_rounds, fuse=fuse,
                window_fuse=window, tile_n=tile_n,
            )
        self._finish_frontier(rounds, final_changed, max_rounds)
        return self._finish_converge(rounds, final_changed)

    def _graph_pass_applies(self) -> bool:
        """Whether an unsharded packed-family sim on a topology other than a
        ring, chain or full mesh runs its rounds (a converge's, step's) as
        the graph pass: on the card, at a shape whose 8-column groups fit a
        block (``pk.graph_pass_fits``). Elsewhere the plain round loop runs,
        a mesh's included."""
        if not (self._card_routes() and self.mesh is None and self.layout in PACKED_FAMILY
                and self.topology.kind not in ("ring", "chain", "mesh")):
            return False
        p, n = self._shape()
        return n % pk.GRAPH_GROUP == 0 and pk.graph_pass_fits(p, len(self.table))

    def _graph_plan(self) -> pk.GraphPlan:
        """The topology's neighbour matrix as the graph pass reads it, built
        once (again where the topology changed)."""
        if self._graph_plan_of is None or self._graph_plan_of[0] is not self.topology:
            self._graph_plan_of = (self.topology, pk.GraphPlan(self.topology.neighbors))
        return self._graph_plan_of[1]

    def _graph_rounds(self, max_rounds: int) -> Tuple[int, int, List[int]]:
        """Up to ``max_rounds`` rounds of the whole-table loop as one graph
        pass over the tracked dirty columns (all where the tracking is
        stale or the topology changed since it was settled). Returns
        (rounds, last round's count, each round's count). A pass that
        reaches the fixed point leaves every column clean; one cut off
        leaves the marks as they are, which still hold every column it may
        have left unsettled."""
        cols = self._frontier_columns() if self._settled_under is self.topology else None
        groups = None if cols is None else np.flatnonzero(self._frontier_groups)
        self.table, rounds, last, counts = pk.gossip_graph_packed(
            self.table, self._graph_plan(), cols, max_rounds, groups)
        if last == 0:
            self._frontier_settled()
        return rounds, last, counts

    def _converge_packed_loop(self, max_rounds: int) -> int:
        """Packed-family whole-table round loop for any topology, one count
        read per round (on a mesh with use_shard_map, a star's rounds are
        the hub reduce, as the reference's). On the card a topology other
        than a ring, chain or full mesh runs the loop as one graph pass
        (``_graph_pass_applies``)."""
        if self._graph_pass_applies():
            rounds, final_changed, _ = self._graph_rounds(max_rounds)
            return self._finish_converge(rounds, final_changed)
        self.table, rounds, final_changed = pk.gossip_until_converged_packed(
            self.table, self.topology, max_rounds,
            spmd=self.mesh is not None and self.use_shard_map,
        )
        return self._finish_converge(rounds, final_changed)

    def _converge_dense_frontier(self, max_rounds: int) -> int:
        """Compacting frontier loop; on the card STRIPE_FUSE rounds fuse
        per kernel step, with the exact classic round count rebuilt on the
        host. On the CPU the plain version runs unfused, as the reference
        runs interpret mode unfused."""
        from ..ops.packed import STRIPE_FUSE
        from ..ops.ring_kernel import gossip_frontier_dense

        tile_n = self._frontier_tile()
        t_total = self._shape()[1] // tile_n
        fuse = STRIPE_FUSE if self._card_routes() else 1
        self.table, rounds, final_changed = gossip_frontier_dense(
            self.table, self._frontier_seed(t_total),
            self.topology.kind == "ring", self.mode, max_rounds,
            fuse=fuse, tile_n=tile_n, lean=self.lean_gossip,
        )
        self._finish_frontier(rounds, final_changed, max_rounds)
        return self._finish_converge(rounds, final_changed)

    def _converge_dense_frontier_spmd(self, max_rounds: int) -> int:
        """The frontier on a mesh: per-shard frontier steps between boundary
        exchanges, the shards' counts summed and compacted. On the card
        HALO_FUSE rounds fuse per exchange (8 boundary rows each way), with
        the exact classic round count rebuilt on the host; on the CPU it
        runs unfused, as the reference's interpret mode does."""
        tile_n = self._frontier_tile()
        t_total = self._shape()[1] // tile_n
        fuse = HALO_FUSE if self._card_routes() else 1
        self.table, rounds, final_changed = gossip_frontier_shardmap_dense(
            self.table, self._frontier_seed(t_total), self.topology.kind == "ring",
            self.mode, self.lean_gossip, max_rounds, fuse=fuse, tile_n=tile_n,
        )
        self._finish_frontier(rounds, final_changed, max_rounds)
        return self._finish_converge(rounds, final_changed)

    def _converge_dense_loop(self, max_rounds: int) -> int:
        """Whole-table round loop for any topology (sharded or not), one
        residual read per round."""
        self.table, rounds, final_changed = until_converged(self._round, self.table, max_rounds)
        return self._finish_converge(rounds, final_changed)

    def reconcile(self) -> None:
        """Directly reconcile every replica to the gossip fixed point —
        WITHOUT simulating protocol rounds — on ANY topology.

        On a strongly connected topology every peer reaches every peer, so
        every row becomes the join of its whole column: ceil(log2 P)
        doubling merges (the merge kernel on the card) on the dense layout,
        one pass of the reconcile kernel on the packed family (on a mesh,
        one per shard, then one over the shards' first rows). Otherwise a
        dynamic program over the SCC condensation joins each component's
        members plus one representative row per successor component.
        Either way the result is bit-identical to run_until_converged's
        fixed point. Pending ops apply first; subscriptions fire as
        usual."""
        self._ensure_capacity()
        self._maybe_rekey()
        self.tick += 1
        self.stats["ops_applied"] += self._apply_pending()
        self.hooks.fire_after_puts()
        if not self.topology.is_connected():
            self._reconcile_weak()
        elif self.layout in PACKED_FAMILY:
            reconcile = reconcile_shardmap_packed if self.mesh is not None else pk.reconcile_packed
            self.table = reconcile(self.table)
        elif self.mesh is not None:
            self.table, _ = mesh_round_shardmap(self.table, self.mode, self.lean_gossip)
        else:
            self.table, _ = gossip_round_mesh(self.table, self.mode, self.lean_gossip)
        self.stats["steps"] += 1
        self.last_residual = 0
        self._frontier_settled()
        self._sync_clocks()
        self._fire_subscriptions()

    def _reconcile_weak(self) -> None:
        """Reconcile a non-strongly-connected topology: per-SCC-closure
        joins over the condensation. Components are processed in ascending
        id order, which Topology.strong_components guarantees is reverse
        topological order of the condensation — every component this one
        pulls from is already at ITS closure, so one representative row
        per successor suffices."""
        comp = self.topology.strong_components()
        n_comp = int(comp.max()) + 1
        members = [np.flatnonzero(comp == c) for c in range(n_comp)]
        succs: List[set] = [set() for _ in range(n_comp)]
        for p in range(self.num_peers):
            cp = int(comp[p])
            for q in self.topology.neighbors[p]:
                if q >= 0 and comp[q] != cp:
                    succs[cp].add(int(comp[q]))
        for c in range(n_comp):
            idx = [
                *members[c].tolist(),
                *(int(members[s][0]) for s in sorted(succs[c])),
            ]
            if len(idx) == 1:
                continue  # singleton with no pulls: already its closure
            if isinstance(self.table, ShardedTable):
                # gather the few rows, join them, write back to each
                # member's shard
                fields = range(4) if self.lean_gossip else None
                rows = self.table.take_rows(np.asarray(idx), self.device, fields)
                beats = (pk.packed_beats if self.layout in PACKED_FAMILY
                         else beats_of(len(rows), self.mode))
                joined = _join_rows(rows, beats)
                k = len(members[c])
                self.table.put_rows(members[c], [r.expand(k, -1) for r in joined], fields)
                continue
            idx_t = torch.tensor(idx, dtype=torch.int64, device=self.device)
            mem_t = torch.from_numpy(members[c]).to(self.device)
            if self.layout in PACKED_FAMILY:
                self.table = _closure_join_packed(self.table, idx_t, mem_t)
            else:
                self.table = _closure_join_dense(
                    self.table, idx_t, mem_t, self.mode, self.lean_gossip
                )

    def _sync_clocks(self) -> None:
        """Lamport clock advance: after gossip every peer's clock must exceed
        any counter it has seen, or later writes could lose ties (lww only;
        reference mode resolves by value and doesn't need it)."""
        if self.mode != "lww":
            return
        if isinstance(self.table, ShardedTable):
            # every process's peers' clocks: each shard's row maxima
            t = self.table
            row_max = disjoint_sum(
                t.mesh, {i: s.ctr.max(dim=1).values for i, s in t.local()}, (t.rows,)
            ).flatten().cpu().numpy().astype(np.int64)
        else:
            row_max = self.table.ctr.max(dim=1).values.cpu().numpy().astype(np.int64)
        self._clock_sync_np()
        np.maximum(self._clock, row_max, out=self._clock)
        self._clock_list = self._clock.tolist()

    def converged(self) -> bool:
        """True iff one more gossip round (the round ``step`` would run)
        would change nothing. An unsharded packed-family ring/chain sim asks
        the count-only probe (the kernel writes nothing, so no table-sized
        scratch at the north-star shape); other sims, a mesh's among them
        as in the reference, run the round on a scratch copy, since the
        port's rounds update in place."""
        self._sync_device_state()
        if (self.layout in PACKED_FAMILY and self.topology.kind in ("ring", "chain")
                and self.mesh is None):
            changed = pk.count_changes_round_packed(
                self.table, self.topology.kind == "ring"
            )
            return int(changed) == 0
        _, changed = self._round(_clone(self.table))
        return int(changed) == 0

    # ----------------------------------------------------------------- reads

    def _sync_device_state(self) -> None:
        """Reads may follow fresh path/value interning: grow the table and
        re-key BEFORE any device access."""
        self._ensure_capacity()
        self._maybe_rekey()

    def _gather_entries(self, peers, slots) -> List[np.ndarray]:
        """The stored fields a read decodes at the K (peer, slot) pairs, in
        one device gather per field: cls and vid on the dense layout, cv on
        the packed and rank layouts, the rank on rank1 (on a mesh one per
        shard)."""
        if self.layout == "dense":
            return self._gather(peers, slots, (0, 3))
        one = self.table.first if isinstance(self.table, ShardedTable) else self.table
        return self._gather(peers, slots, (len(one) - 1,))  # cv, or rank1's rank

    def _present_vid(self, entries: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """(present, vid) of ``_gather_entries``' fields. Rank1 decodes the
        ranks on the host through the RankIndex; a rank with no exact hit
        reads as absent."""
        if self.layout == "dense":
            cls, vid = entries
            return cls != CLS_ABSENT, vid
        if self.layout == "rank1":
            vid = self.rank_index.decode_ranks(entries[0])
            return vid >= 0, vid
        cv = entries[0]
        return (cv >> pk.CV_SHIFT) != CLS_ABSENT, cv & pk.VID_MASK

    def _gather(self, peers, slots, fields: Sequence[int]) -> List[np.ndarray]:
        """The entries at the K (peer, slot) pairs of the field indices
        ``fields``, as numpy arrays: one device gather per field (per shard
        and field on a mesh)."""
        if isinstance(self.table, ShardedTable):
            return self.table.gather(peers, slots, fields)
        idx = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(self.device)
            for a in (peers, slots)
        )
        return [self.table[f][idx].cpu().numpy() for f in fields]

    def _decode_slots(self, peer: int, slots: List[int]) -> Dict[int, Any]:
        if not slots:
            return {}
        self._sync_device_state()
        slots_np = np.asarray(slots, dtype=np.int64)
        with observe.span("get.gather"):
            entries = self._gather_entries(np.full(len(slots_np), peer, dtype=np.int64), slots_np)
        with observe.span("get.decode"):
            sel, vid = self._present_vid(entries)
            dec = self.host.values.decode_batch(np.where(vid[sel] == VID_NULL, 0, vid[sel]))
            out: Dict[int, Any] = {}
            for slot, v, d in zip(slots_np[sel].tolist(), vid[sel].tolist(), dec):
                out[slot] = None if v == VID_NULL else d
            return out

    def get(self, peer: int, path: str = "") -> Any:
        """Read a value/subtree at ``peer`` (device gather + host tree
        rebuild). Missing paths return None. Get hooks may rewrite the
        path; afterGet hooks may rewrite the data
        (bullet-middleware.js:27-68). The span ``get``, with ``get.lookup``,
        ``get.gather``, ``get.decode`` and ``get.tree`` inside."""
        with observe.span("get"):
            if self.hooks.active:
                path = self.hooks.rewrite_get(peer, path)
                return self.hooks.rewrite_after_get(peer, path, self._get_raw(peer, path))
            return self._get_raw(peer, path)

    def _get_raw(self, peer: int, path: str = "") -> Any:
        if path:
            with observe.span("get.lookup"):
                pid = self.host.paths.lookup(path)
                if pid is None:
                    return None
                slots = [pid, *self.host.leaf_slots_under(pid)]
            values = self._decode_slots(peer, slots)
            with observe.span("get.tree"):
                tree = self.host.build_tree(pid, values)
                return None if tree is MISSING else tree
        with observe.span("get.lookup"):
            roots = self.host.paths.top_level()
        values = self._decode_slots(peer, list(range(len(self.host.paths))))
        with observe.span("get.tree"):
            out = {}
            for r in roots:
                sub = self.host.build_tree(r, values)
                if sub is not MISSING:
                    out[self.host.paths.segment(r)] = sub
            return out

    def get_bulk(self, peers, paths) -> List[Any]:
        """Batched point reads — the read twin of ``put_bulk``: ONE device
        gather for all K (peer, path) pairs, then a columnar host decode.
        ``peers`` is an int array [K] or a single int; ``paths`` is a list
        of K path strings or an int32 array of pre-interned slot ids.
        Returns K leaf values (None for null, absent, unknown, or interior
        paths). Get hooks (path rewrite + afterGet data rewrite) apply per
        pair when registered, to path strings only. The span ``get_bulk``,
        with ``get.lookup`` (path strings), ``get.gather`` and
        ``get.decode`` inside."""
        with observe.span("get_bulk"):
            return self._get_bulk(peers, paths)

    def _get_bulk(self, peers, paths) -> List[Any]:
        path_strs = None
        if isinstance(paths, np.ndarray) and paths.dtype.kind == "i":
            slots = paths.astype(np.int32)
            valid = slots >= 0
        else:
            paths = list(paths)
            if self.hooks.active:
                prow = np.broadcast_to(np.asarray(peers, dtype=np.int32), (len(paths),))
                paths = [self.hooks.rewrite_get(int(pr), p) for pr, p in zip(prow, paths)]
            with observe.span("get.lookup"):
                slots = self.host.paths.lookup_batch(paths)
            valid = slots >= 0
            slots = np.where(valid, slots, 0).astype(np.int32)
            path_strs = paths
        k = len(slots)
        peers_arr = np.broadcast_to(np.asarray(peers, dtype=np.int32), (k,))
        self._sync_device_state()
        with observe.span("get.gather"):
            entries = self._gather_entries(peers_arr, slots)
        with observe.span("get.decode"):
            present, vid = self._present_vid(entries)
            present &= valid & (vid != VID_NULL)
            out_arr = np.full(k, None, dtype=object)
            if present.any():
                uniq, inverse = np.unique(vid[present], return_inverse=True)
                out_arr[present] = self.host.values.decode_batch(uniq)[inverse]
            out: List[Any] = out_arr.tolist()
        if self.hooks.active and path_strs is not None:
            out = [self.hooks.rewrite_after_get(int(pr), p, v)
                   for pr, p, v in zip(peers_arr, path_strs, out)]
        return out

    # --------------------------------------------------------------- queries

    def _mask_paths_row(self, row_mask: torch.Tensor, parents: bool = False) -> List[str]:
        """A hit mask [N] as sorted path strings: only the hit indices cross
        to the host, then one batched path pass. ``parents=True`` maps each
        hit to its parent path (the field form's result shape, bullet-js
        node-path results)."""
        hits = torch.nonzero(row_mask).flatten().cpu().numpy()
        if parents:
            hits = self.host.paths.parents_batch(hits)
        return sorted(self.host.paths.paths_batch(hits))

    def equals(self, peer: int, base: str, field: Optional[str], value: Any = MISSING):
        """Equals scan over one peer's row (bullet-js query ``equals``):
        the children of ``base`` whose ``field`` (or, with no field, whose
        own value) is ``value``."""
        if value is MISSING:
            field, value = None, field
        res = self._equals_mask(peer, base, field, value)
        return [] if res is None else self._mask_paths_row(*res)

    def count(self, peer: int, base: str, field, value: Any = MISSING) -> int:
        """Match count on the device (bullet-js query ``count``): one
        scalar crosses to the host, not the mask. Accepts a Predicate in
        place of (field, value)."""
        if isinstance(field, Predicate):
            res = self._predicate_mask(peer, base, field)
            return 0 if res is None else int(res[1])
        if value is MISSING:
            field, value = None, field
        res = self._equals_mask(peer, base, field, value)
        return 0 if res is None else int(scans.count_mask(res[0]))

    def _equals_mask(self, peer: int, base: str, field: Optional[str], value: Any):
        """(mask [N], whether hits map to their parents) of an equals probe
        at ``peer``, on the row's device; None when nothing can match (an
        unknown base or field, a rank1 value never ranked)."""
        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return None
        # the probe interns before the sync: a re-key or growth it causes
        # reaches the table before the scan
        _, _, _, vid = self.host.encode_value(value)
        self._sync_device_state()
        if self.layout == "rank1":
            # value identity is one rank compare (ranks are a bijection
            # over vids): no RowView rebuild
            probe = self._probe_rank(vid)
            if probe == 0:
                return None  # value never ranked: never applied anywhere
            row = self._rank_row(peer)
            field_mask, leaf_mask = scans.equals_field_mask_rank, scans.equals_leaf_mask_rank
        else:
            probe, row = vid, self._peer_row(peer)
            field_mask, leaf_mask = scans.equals_field_mask_row, scans.equals_leaf_mask_row
        struct = self.host.struct(_row_device(row))
        if field is None:
            return leaf_mask(row, struct, base_pid, probe), False
        fid = self.host.seg_lookup(field)
        if fid < 0:
            return None
        return field_mask(row, struct, base_pid, fid, probe), True

    def _probe_rank(self, vid: int) -> int:
        """The query probe's rank for a vid (rank1): 0 if the vid was never
        ranked, i.e. the value was never applied on any peer, so an equality
        scan cannot match (live ranks are >= 1). A vid past the index's
        length is such a vid."""
        if vid < len(self.rank_index._rank_of):
            return self.rank_index.rank_of(vid)
        return 0

    def range(self, peer: int, base: str, field, lo=MISSING, hi=MISSING):
        """Numeric range scan over one peer's row, inclusive at both ends
        (bullet-js query ``range``)."""
        if hi is MISSING:
            field, lo, hi = None, field, lo
        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return []
        keys = (*number_key(float(lo)), *number_key(float(hi)))
        self._sync_device_state()
        if self.layout == "rank1":
            # keys in [lo, hi] of the number class form one contiguous rank
            # run (ranks are lexicographic in (cls, khi, klo, vid))
            bounds = self.rank_index.rank_bounds(CLS_NUMBER, *keys)
            if bounds is None:
                return []
            row = self._rank_row(peer)
            field_mask, leaf_mask = scans.range_field_mask_rank, scans.range_leaf_mask_rank
        else:
            bounds, row = keys, self._peer_row(peer)
            field_mask, leaf_mask = scans.range_field_mask_row, scans.range_leaf_mask_row
        struct = self.host.struct(_row_device(row))
        if field is None:
            return self._mask_paths_row(leaf_mask(row, struct, base_pid, *bounds))
        fid = self.host.seg_lookup(field)
        if fid < 0:
            return []
        return self._mask_paths_row(field_mask(row, struct, base_pid, fid, *bounds),
                                    parents=True)

    def filter(self, peer: int, base: str, fn) -> List[str]:
        """Child scan with a predicate (bullet-js query ``filter``): a
        :class:`~bullet_tpu_torch.ops.predicates.Predicate` runs on the
        device as one mask program, never decoding the subtree; any other
        callable ``fn(value, key)`` (or ``fn(value)``) scans the decoded
        children on the host."""
        if isinstance(fn, Predicate):
            res = self._predicate_mask(peer, base, fn)
            return [] if res is None else self._mask_paths_row(res[0])
        data = self.get(peer, base)
        if not isinstance(data, dict):
            return []
        return sorted(f"{base}/{key}" for key, value in data.items() if _pred(fn, value, key))

    def _predicate_mask(self, peer: int, base: str, pred):
        """(mask bool [N] over path ids, count int32 0-d), both on the row's
        device, for a Predicate; None when ``base`` was never interned."""
        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return None
        # the probes resolve before the sync: encoding may intern new
        # values or re-key strings (the order equals() keeps)
        params = predicate_params(pred, self.host.seg_lookup, self.host.encode_value)
        self._sync_device_state()
        row = self._peer_row(peer)
        device = _row_device(row)
        return compile_predicate(pred)(
            row, self.host.struct(device), base_pid,
            torch.tensor(params, dtype=torch.int32, device=device),
        )

    def find(self, peer: int, base: str, fn) -> Optional[str]:
        """The first child (sorted by path for a Predicate, in key order
        for a callable) satisfying ``fn``, or None."""
        if isinstance(fn, Predicate):
            hits = self.filter(peer, base, fn)
            return hits[0] if hits else None
        data = self.get(peer, base)
        if isinstance(data, dict):
            for key, value in data.items():
                if _pred(fn, value, key):
                    return f"{base}/{key}"
        return None

    def map(self, peer: int, base: str, fn: Callable) -> List[Any]:
        """``fn(value, key)`` (or ``fn(value)``) of every child of ``base``."""
        data = self.get(peer, base)
        if not isinstance(data, dict):
            return []
        return [_pred(fn, value, key) for key, value in data.items()]

    def _row_home(self, peer: int):
        """(table, row): the table holding ``peer``'s row (on a mesh its
        owning shard, on that shard's device; across processes a copy of
        the row that its owner broadcast) and the row's index there."""
        if isinstance(self.table, ShardedTable):
            return self.table.row_table(peer)
        return self.table, peer

    def _rank_row(self, peer: int) -> torch.Tensor:
        """One rank1 replica row, int32 [N], where it lives."""
        table, row = self._row_home(peer)
        return table.rank[row]

    def _peer_row(self, peer: int) -> scans.RowView:
        """One replica row as a query RowView, for every layout, on the
        device of the table or shard that holds it. The packed family
        rebuilds the value keys: rank through the interner's key tables,
        rank1 by decoding its ranks through the RankIndex's inverse
        first (an empty index: an all-absent view)."""
        table, row = self._row_home(peer)
        if self.layout == "dense":
            return scans.peer_row(table, row)
        if self.layout == "packed":
            cv = table.cv[row]
            return scans.RowView(cls=cv >> pk.CV_SHIFT, khi=table.khi[row], klo=table.klo[row],
                                 vid=cv & pk.VID_MASK)
        device = table[0].device
        if self.layout == "rank":
            cv = table.cv[row]
            vid = cv & pk.VID_MASK
            cls = cv >> pk.CV_SHIFT
            present = cls > 0
            _c, khi_map, klo_map = self.host.key_tables()
            khi_map, klo_map = self._device_lut(khi_map, device), self._device_lut(klo_map, device)
            return scans.RowView(
                cls=cls,
                khi=torch.where(present, rk._lookup(khi_map, vid), 0),
                klo=torch.where(present, rk._lookup(klo_map, vid), 0),
                vid=vid,
            )
        rank = table.rank[row]
        if len(self.rank_index) == 0:
            z = torch.zeros_like(rank)
            return scans.RowView(cls=z, khi=z, klo=z, vid=z)
        cls_map, khi_map, klo_map = (self._device_lut(m, device) for m in self.host.key_tables())
        sranks, svids = (self._device_lut(a, device) for a in self.rank_index.inverse_arrays())
        present, vid = rk.decode_vids_rank1(rank, sranks, svids)
        vid = torch.where(present, vid, 0)
        return scans.RowView(
            cls=torch.where(present, rk._lookup(cls_map, vid), 0),
            khi=torch.where(present, rk._lookup(khi_map, vid), 0),
            klo=torch.where(present, rk._lookup(klo_map, vid), 0),
            vid=vid,
        )

    # ------------------------------------------- facade: validation + hooks

    def define_schema(self, name: str, schema: dict) -> "PeerNetworkSim":
        """Register a named schema (bullet-validation.js:54-63)."""
        self.validation.define_schema(name, schema)
        return self

    def apply_schema(self, base_path: str, schema_name: str) -> "PeerNetworkSim":
        """Bind a schema to a base path; writes under it validate at batch
        ingress — host typed checks for ``put``, the device mask for bulk
        batches."""
        self.validation.apply_schema(base_path, schema_name)
        return self

    def remove_schema(self, base_path: str) -> "PeerNetworkSim":
        self.validation.remove_schema(base_path)
        return self

    def on_validation_error(self, error_type: str, handler) -> "PeerNetworkSim":
        self.validation.on_error(error_type, handler)
        return self

    def validate(self, schema_name: str, data: Any) -> bool:
        return self.validation.validate(schema_name, data)

    def use(self, operation: str, fn: Callable) -> "PeerNetworkSim":
        """Register a middleware hook (put/afterPut/get/afterGet/delete/
        afterDelete — bullet-middleware.js:198-209)."""
        self.hooks.use(operation, fn)
        return self

    def use_traced_put(self, fn: Callable) -> "PeerNetworkSim":
        """Register a pure OpBatch transform run on the device over every
        drained batch (see ``EngineHooks.use_traced_put``)."""
        self.hooks.use_traced_put(fn)
        return self

    def on_event(self, event: str, listener: Callable) -> "PeerNetworkSim":
        """Subscribe to engine events ("write", "read", "delete", "error",
        "all" — bullet-middleware.js:278-313)."""
        self.hooks.on_event(event, listener)
        return self

    # -------------------------------------------------- facade: serialization

    def _scratch_bullet(self, peer: Optional[int] = None):
        """A throwaway storage-less, network-less Bullet of this package;
        seeded with ``peer``'s replica when given (the serializer works on
        a Bullet's store)."""
        from .. import create

        b = create({"storage": False, "disable_network": True})
        if peer is not None:
            from .bridge import dump_sim_into_bullet

            dump_sim_into_bullet(self, b, peer=peer)
        return b

    def export_to_json(self, peer: int, path: str = "", options=None) -> str:
        """Serialize a peer's replica in the db layer's formats (the
        bullet-serializer.js envelope) through a scratch Bullet."""
        b = self._scratch_bullet(peer)
        try:
            return b.export_to_json(path, options)
        finally:
            b.close()

    def export_to_csv(self, peer: int, path: str, options=None) -> str:
        b = self._scratch_bullet(peer)
        try:
            return b.export_to_csv(path, options)
        finally:
            b.close()

    def export_to_xml(self, peer: int, path: str, options=None) -> str:
        b = self._scratch_bullet(peer)
        try:
            return b.export_to_xml(path, options)
        finally:
            b.close()

    def _import_via_bullet(self, peer: int, importer) -> dict:
        """Run ``importer`` on a scratch Bullet; only if it succeeds, queue
        its store's leaves as puts at ``peer``."""
        b = self._scratch_bullet()
        try:
            result = importer(b)
            if result.get("success"):
                from .bridge import load_bullet_into_sim

                load_bullet_into_sim(b, self, peer=peer)
            return result
        finally:
            b.close()

    def import_from_json(self, peer: int, json_str: str, target_path=None,
                         options=None) -> dict:
        """Parse the db layer's JSON format and queue its leaves as puts at
        ``peer`` (step/run_until_converged applies them)."""
        return self._import_via_bullet(
            peer, lambda b: b.import_from_json(json_str, target_path, options))

    def import_from_csv(self, peer: int, csv_str: str, target_path: str,
                        options=None) -> dict:
        return self._import_via_bullet(
            peer, lambda b: b.import_from_csv(csv_str, target_path, options))

    def import_from_xml(self, peer: int, xml_str: str, target_path: str,
                        options=None) -> dict:
        return self._import_via_bullet(
            peer, lambda b: b.import_from_xml(xml_str, target_path, options))

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self, directory: str, backend: str = "npz") -> None:
        """``state.npz`` + ``meta.json`` under ``directory``, in the
        reference package's format (see ``models/checkpoint.py``)."""
        from .checkpoint import save_checkpoint

        save_checkpoint(self, directory, backend=backend)

    @staticmethod
    def load_checkpoint(directory: str, mesh_devices=None, *, device="cuda"):
        """A working sim from a checkpoint of either package, on ``device``."""
        from .checkpoint import load_checkpoint

        return load_checkpoint(directory, mesh_devices, device=device)

    # ---------------------------------------------------------- subscriptions

    def peer(self, index: int):
        """Peer-scoped fluent view: ``sim.peer(3).get("users/a").put(...)``."""
        from .node import SimPeer

        return SimPeer(self, index)

    def off(self, peer: int, path: str, callback: Optional[Callable] = None) -> None:
        """Unsubscribe."""
        self._subs = [
            s for s in self._subs
            if not (
                s["peer"] == peer
                and s["path"] == path
                and (callback is None or s["callback"] is callback)
            )
        ]
        self._watch_dirty = True

    def on(self, peer: int, path: str, callback: Callable[[Any], None]) -> None:
        """Subscribe to a path at a peer; fires immediately with the current
        value and after any step that changes it (ancestor bubbling falls
        out: a subtree read changes when any descendant leaf changes)."""
        self.host.intern_path(path)
        current = self.get(peer, path)
        callback(current)
        self._subs.append(
            {"peer": peer, "path": path, "callback": callback, "last": current}
        )
        self._watch_dirty = True

    # -- changed-slot dispatch: ONE gather pulls the (cls, vid) of every
    # watched slot, a numpy compare against the previous snapshot yields
    # the subscriptions whose slots changed, and only THOSE re-read their
    # subtree.

    def _build_watch_index(self) -> None:
        peers, slots, sub_of = [], [], []
        for si, sub in enumerate(self._subs):
            pid = self.host.paths.lookup(sub["path"]) if sub["path"] else None
            if sub["path"]:
                watch = ([pid, *self.host.leaf_slots_under(pid)]
                         if pid is not None else [])
            else:  # root watch: every slot
                watch = list(range(len(self.host.paths)))
            for s in watch:
                peers.append(sub["peer"])
                slots.append(s)
                sub_of.append(si)
        self._watch_peers = np.asarray(peers, dtype=np.int32)
        self._watch_slots = np.asarray(slots, dtype=np.int32)
        self._watch_subof = np.asarray(sub_of, dtype=np.int64)
        self._watch_paths_len = len(self.host.paths)
        self._watch_dirty = False
        self._watch_prev = None  # unknown baseline: check every sub once

    def _gather_watch_values(self) -> np.ndarray:
        if len(self._watch_peers) == 0:
            return np.empty((0,), dtype=np.int64)
        present, vid = self._present_vid(
            self._gather_entries(self._watch_peers, self._watch_slots))
        return np.where(present, vid.astype(np.int64), -1)

    def _fire_subscriptions(self) -> None:
        if not self._subs:
            return
        self._sync_device_state()
        if (
            getattr(self, "_watch_dirty", True)
            or self._watch_paths_len != len(self.host.paths)
        ):
            self._build_watch_index()
        values = self._gather_watch_values()
        if self._watch_prev is None:
            changed_subs = range(len(self._subs))
        else:
            diff = values != self._watch_prev
            changed_subs = np.unique(self._watch_subof[diff]).tolist()
        self._watch_prev = values
        for si in changed_subs:
            sub = self._subs[si]
            value = self.get(sub["peer"], sub["path"])
            if value != sub["last"]:
                sub["last"] = value
                try:
                    sub["callback"](value)
                except Exception:  # noqa: BLE001 - listener isolation
                    pass

    # ------------------------------------------------------------- lifecycle

    def snapshot(self) -> dict:
        """Host checkpoint of device state, in the reference package's
        snapshot format. Pending puts are FLUSHED (applied) first, so a
        snapshot captures every put issued before it. On a mesh of
        processes every process gets the whole table on its host: each
        shard's owner broadcasts it (the table's bytes to every process,
        through a shard-sized buffer on the home device)."""
        if any(self._pending) or self._pending_bulk:
            self.step(rounds=0)
        self._sync_device_state()
        snap = {
            "table": list(table_to_numpy(self.table)),
            "tick": self.tick,
            "clock": self._clock_snapshot(),
            "capacity": self.capacity,
        }
        if self.layout in RANK_FAMILY:
            # ranks mean something only against one RankIndex epoch: restore
            # re-keys when the epoch moved
            snap["rank_epoch"] = self.rank_index.epoch
            if self.layout == "rank1":
                # no vid column to decode stale ranks through: the snapshot
                # carries its own epoch's inverse
                sr, sv = self.rank_index.inverse_arrays()
                snap["rank_inverse"] = (sr.copy(), sv.copy())
        return snap

    def restore(self, snap: dict) -> None:
        """Rewind to EXACTLY the snapshot state; accepts this class's
        snapshots and the reference package's ``snapshot()`` dicts of the
        same layout.
        Pending (un-applied) puts are DISCARDED: they belong to the
        abandoned post-snapshot timeline. The host interners are not part
        of a snapshot. A rank or rank1 snapshot from another RankIndex
        epoch is re-keyed to the current one (through cv, or through the
        snapshot's own ``rank_inverse``). On a mesh of processes each
        process takes its own shards' rows of the snapshot's whole table."""
        for ops in self._pending:
            ops.clear()
        self._pending_bulk.clear()
        self._frontier_dirty = None
        if self.layout in RANK_FAMILY:
            # bring the index current BEFORE swapping tables: a pending insert
            # could respread, and a rank1 re-key through prev_inverse only
            # matches the current table's epoch
            self._sync_rank_index()
        if self.mesh is not None:
            self.table = sharded_from_numpy(snap["table"], self.mesh, self.layout)
        else:
            self.table = FROM_NUMPY[self.layout](snap["table"], self.device)
        if self.layout in RANK_FAMILY:
            # a snapshot's ranks hold under the index that took it, which may
            # be another sim's (the reference's, carried across), so epochs
            # are not compared: rank re-gathers from cv, one pass; rank1
            # decodes through the snapshot's own inverse unless it is the
            # current one
            if self.layout == "rank":
                self._rekey_rank()
            else:
                osr, osv = (np.asarray(a) for a in snap["rank_inverse"])
                sr, sv = self.rank_index.inverse_arrays()
                # an empty inverse means an all-absent table
                if len(osr) and not (np.array_equal(osr, sr) and np.array_equal(osv, sv)):
                    self._rekey_rank1(osr, osv)
        self.tick = snap["tick"]
        self._clock = np.asarray(snap["clock"], dtype=np.int64).copy()
        self._clock_list = self._clock.tolist()
        self.capacity = snap["capacity"]

    def tables_equal(self) -> bool:
        """All peers bit-identical in (cls, vid) — the convergence
        acceptance check (cv alone on the packed and rank layouts: cv equal
        <=> (cls, vid) equal; the rank alone on rank1, a bijection over
        entries). Computed on the device; one scalar crosses to the
        host."""
        # the compared fields' indices: (vid, cls) dense, cv packed and
        # rank, the rank rank1
        fields = {"dense": (3, 0), "packed": (2,), "rank": (1,), "rank1": (0,)}[self.layout]
        t = self.table
        if not isinstance(t, ShardedTable):
            return all(bool((t[f] == t[f][0:1]).all()) for f in fields)
        # peer 0's row (from its owner), against this process's shards; the
        # verdicts summed over the processes
        first, row = t.row_table(0)
        differ = sum(
            not bool((s[f] == first[f][row:row + 1].to(s[f].device)).all())
            for _, s in t.local() for f in fields
        )
        return all_sum_int(t.mesh, differ) == 0


def _pred(fn, value, key):
    """``fn(value, key)``, or ``fn(value)`` for a one-argument callable."""
    try:
        return fn(value, key)
    except TypeError:
        return fn(value)


def _row_device(row) -> torch.device:
    """The device of a query row: a RowView or a rank1 row tensor."""
    return (row.vid if isinstance(row, scans.RowView) else row).device
