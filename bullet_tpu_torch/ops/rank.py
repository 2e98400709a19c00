"""Rank table layouts: the port of ``bullet_tpu.ops.rank``.

The packed layout stores (khi, klo, cv) = 12 B/entry and every merge
compares the 4-key chain (cls, khi, klo, vid). The merge priority only
depends on the total order over those keys, so a host-maintained 31-bit
gap rank over the distinct (cls, khi, klo) triples, refined by vid
(``RankIndex``), collapses the layout to

    rank, cv : int32 [P, N]   -> 8 B/entry  (RankTable; cv = cls << 28 | vid)
    rank     : int32 [P, N]   -> 4 B/entry  (Rank1Table)

Distinct vids get distinct ranks, strictly monotone in (cls, khi, klo,
vid), so the rank alone decides every merge and equal ranks mean equal
entries. Absent entries are rank 0 / cv 0; live ranks are >= 1, so padding
never wins. Rank1 drops cv: reads decode a rank to its vid through the
index's inverse (sorted live ranks and their vids), and an inexact hit
reads as absent.

Every gossip, frontier, reconcile, apply and window kernel is shared with
``ops/packed.py``: the kernels and plain versions dispatch on the field
count (3 = packed, 2 = rank, 1 = rank1). This module adds what is rank
specific: the layout types, the host rank maintenance (gap ranks with an
even respread and a device re-key), the op pre-reduction and the flat
apply. The conversions and re-keys update in place, on column blocks,
where the reference donated its buffers.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from .packed import CV_SHIFT, VID_MASK, PackedTable, apply_flat_packed

RANK_SPAN = (1 << 31) - 1  # usable rank space: [1, 2^31 - 1]

# element-wise passes over a table work on column blocks of at most this
# many entries per field: their int64 index temporaries stay small next to
# a north-star-sized table
_BLOCK_ELEMS = 1 << 24


class RankTable(NamedTuple):
    """Reference-mode replica tables at 8 B/entry. cv is last, as in the
    reference: the presence guard reads cls from ``fields[-1] >> 28`` and
    the field count (2) selects the rank key chain."""

    rank: torch.Tensor
    cv: torch.Tensor  # cls << 28 | vid


class Rank1Table(NamedTuple):
    """Reference-mode replica tables at 4 B/entry: the rank alone (a
    bijection over live entries; 0 = absent)."""

    rank: torch.Tensor


def init_rank(num_peers: int, capacity: int, device) -> RankTable:
    """All-absent rank table; two distinct allocations (the kernels update
    fields in place)."""
    return RankTable(*(
        torch.zeros((num_peers, capacity), dtype=torch.int32, device=device)
        for _ in range(2)
    ))


def init_rank1(num_peers: int, capacity: int, device) -> Rank1Table:
    return Rank1Table(torch.zeros((num_peers, capacity), dtype=torch.int32, device=device))


def _column_blocks(fields) -> Iterator[List[torch.Tensor]]:
    """Views of ``fields`` ([P, N] each) on column blocks of at most
    _BLOCK_ELEMS entries."""
    p, n = fields[0].shape
    width = max(1, _BLOCK_ELEMS // max(p, 1))
    for c0 in range(0, n, width):
        yield [f[:, c0:c0 + width] for f in fields]


def _lookup(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lut[idx] with the index clamped into the table, as the reference's
    gathers clamp (only absent entries can point outside)."""
    return lut[idx.to(torch.int64).clamp_(0, lut.numel() - 1)]


# ------------------------------------------------------------ conversions


def pack_to_rank(pt: PackedTable, rank_map: torch.Tensor) -> RankTable:
    """PackedTable -> RankTable through the vid -> rank LUT (absent entries
    stay 0). The packed cv becomes the rank table's cv; khi and klo are
    dropped."""
    rank = torch.empty_like(pt.cv)
    for r, cv in _column_blocks((rank, pt.cv)):
        present = (cv >> CV_SHIFT) > 0
        r.copy_(torch.where(present, _lookup(rank_map, cv & VID_MASK), 0))
    return RankTable(rank=rank, cv=pt.cv)


def rank_to_packed(rt: RankTable, khi_map: torch.Tensor, klo_map: torch.Tensor) -> PackedTable:
    """RankTable -> a new PackedTable through the vid -> (khi, klo) LUTs."""
    khi, klo = torch.empty_like(rt.cv), torch.empty_like(rt.cv)
    for kh, kl, cv in _column_blocks((khi, klo, rt.cv)):
        present = (cv >> CV_SHIFT) > 0
        vid = cv & VID_MASK
        kh.copy_(torch.where(present, _lookup(khi_map, vid), 0))
        kl.copy_(torch.where(present, _lookup(klo_map, vid), 0))
    return PackedTable(khi=khi, klo=klo, cv=rt.cv.clone())


def rekey_rank(table: RankTable, rank_map: torch.Tensor) -> RankTable:
    """Refresh the ranks from cv's vid after a respread, in place (cv does
    not depend on the ranks)."""
    for rank, cv in _column_blocks(table):
        present = (cv >> CV_SHIFT) > 0
        rank.copy_(torch.where(present, _lookup(rank_map, cv & VID_MASK), rank))
    return table


def decode_vids_rank1(
    rank: torch.Tensor, sranks: torch.Tensor, svids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(present, vid) for rank1 entries: binary-search each rank in the
    sorted live ranks and read the matching vid. ``present`` demands an
    exact hit, so a stale rank that the inverse no longer holds reads as
    absent, never as a nearby wrong vid."""
    if sranks.numel() == 0:
        return torch.zeros_like(rank, dtype=torch.bool), torch.zeros_like(rank)
    sranks = sranks.to(rank.dtype)
    idx = torch.searchsorted(sranks, rank).clamp_(0, svids.numel() - 1)
    return (rank > 0) & (sranks[idx] == rank), svids[idx]


def pack_to_rank1(pt: PackedTable, rank_map: torch.Tensor) -> Rank1Table:
    """PackedTable -> Rank1Table through the vid -> rank LUT."""
    return Rank1Table(rank=pack_to_rank(pt, rank_map).rank)


def rank_to_rank1(rt: RankTable) -> Rank1Table:
    return Rank1Table(rank=rt.rank)


def rank1_to_rank(
    rt: Rank1Table, sranks: torch.Tensor, svids: torch.Tensor, cls_map: torch.Tensor
) -> RankTable:
    """Rank1Table -> RankTable, rebuilding cv through the inverse LUT."""
    cv = torch.empty_like(rt.rank)
    for out, rank in _column_blocks((cv, rt.rank)):
        present, vid = decode_vids_rank1(rank, sranks, svids)
        vid = vid.to(torch.int32)
        out.copy_(torch.where(present, (_lookup(cls_map, vid) << CV_SHIFT) | vid, 0))
    return RankTable(rank=rt.rank, cv=cv)


def rekey_rank1_torch(
    table: Rank1Table, old_sranks: torch.Tensor, old_svids: torch.Tensor,
    rank_map: torch.Tensor,
) -> Rank1Table:
    """Plain version of ``rekey_rank1``, in place on column blocks."""
    for (rank,) in _column_blocks(table):
        present, vid = decode_vids_rank1(rank, old_sranks, old_svids)
        rank.copy_(torch.where(present, _lookup(rank_map, vid), 0))
    return table


# device -> int64 [1]: the binary searches that rekey_rank1's kernel ran on
# that device, summed over its launches (tests and chip_smoke.py read and
# zero it; the main path never waits on it)
_REKEY_SEARCHES: dict = {}


def rekey_searches(device) -> torch.Tensor:
    """The counter of ``rekey_rank1``'s binary searches on ``device``: one
    per run of equal ranks down a column (an entry > 0 that differs from
    the row above, or stands in the first row)."""
    device = torch.device(device)
    if device not in _REKEY_SEARCHES:
        _REKEY_SEARCHES[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _REKEY_SEARCHES[device]


def rekey_rank1(
    table: Rank1Table, old_sranks: torch.Tensor, old_svids: torch.Tensor,
    rank_map: torch.Tensor,
) -> Rank1Table:
    """Re-gather a rank1 table onto a fresh rank epoch, in place: decode
    each stale rank to its vid through the PRE-respread inverse
    (``RankIndex.prev_inverse``), then gather the new rank. The CUDA kernel
    (one pass down the columns, one search a run of equal ranks) for CUDA
    tensors; the plain version for CPU tensors."""
    rank = table.rank
    device = rank.device
    if device.type == "cpu":
        return rekey_rank1_torch(table, old_sranks, old_svids, rank_map)
    _build.require_cuda(device, "rekey_rank1")
    p, n = rank.shape
    _build.check_fields((rank,), (p, n), device, "rekey_rank1")
    count = old_sranks.numel()
    _build.check_fields((old_sranks, old_svids), (count,), device, "rekey_rank1 inverse")
    _build.check_fields((rank_map,), (rank_map.numel(),), device, "rekey_rank1 rank_map")
    if count and not rank_map.numel():
        raise ValueError("rekey_rank1: an empty rank_map cannot re-key a non-empty inverse")
    if rank.numel() == 0:
        return table
    searches = rekey_searches(device)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.bt_rekey_rank1(
            rank.data_ptr(), p, n, old_sranks.data_ptr(), old_svids.data_ptr(), count,
            rank_map.data_ptr(), rank_map.numel(), searches.data_ptr(),
            _build.stream_of(device),
        )
    _build.check(err, "rekey_rank1")
    _build.LAUNCHES["rekey_rank1"] += 1
    return table


# --------------------------------------------------------------- flat apply


def apply_flat_rank_stacked(table: RankTable, ops: torch.Tensor) -> Tuple[RankTable, torch.Tensor]:
    """Flat apply on the rank layout over a stacked [4, K] op array (rows
    peer, slot, rank, cv; unique (peer, slot) pairs, as
    ``reduce_flat_ops_rank`` emits), in place: the ``apply_packed`` kernel
    for CUDA tensors. Returns (table, applied count)."""
    return apply_flat_packed(table, ops)


def apply_flat_rank(table: RankTable, peer, slot, rank, cv) -> Tuple[RankTable, torch.Tensor]:
    return apply_flat_rank_stacked(table, torch.stack([peer, slot, rank, cv]))


def apply_flat_rank1_stacked(
    table: Rank1Table, ops: torch.Tensor
) -> Tuple[Rank1Table, torch.Tensor]:
    """Flat apply on the rank1 layout over a stacked [3, K] op array (rows
    peer, slot, rank): an op lands iff its rank beats the entry's (rank 0
    ops are absent). Returns (table, applied count)."""
    return apply_flat_packed(table, ops)


def apply_flat_rank1(table: Rank1Table, peer, slot, rank) -> Tuple[Rank1Table, torch.Tensor]:
    return apply_flat_rank1_stacked(table, torch.stack([peer, slot, rank]))


def reduce_flat_ops_rank(peer, slot, rank, cv):
    """Host-side lattice pre-reduction on rank ops: the (rank, cv)-max live
    op (cls > 0) per (peer, slot), sorted by (peer, slot), as (peer, slot,
    rank, cv) int32 arrays; None when no op is live.

    The native pass (``native.reduce_flat_ops_rank``) runs when the library
    is available; this numpy body is its bit-identical fallback: the winner
    key fuses into one int64 (rank * 2^32 | cv, both non-negative), so one
    argsort and one ``maximum.reduceat`` find every group's winner."""
    from .. import native

    fast = native.reduce_flat_ops_rank(peer, slot, rank, cv, 0, 0, CV_SHIFT)
    if fast is not NotImplemented:
        return fast

    keep = (np.asarray(cv) >> CV_SHIFT) > 0
    peer, slot, rank, cv = (np.asarray(a)[keep] for a in (peer, slot, rank, cv))
    if peer.size == 0:
        return None
    pslot = (peer.astype(np.int64) << 32) | slot.astype(np.int64)
    wkey = (rank.astype(np.int64) << 32) | cv.astype(np.int64)
    order = np.argsort(pslot)
    ps = pslot[order]
    first = np.empty(ps.size, dtype=bool)
    first[0] = True
    np.not_equal(ps[1:], ps[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    wmax = np.maximum.reduceat(wkey[order], starts)
    keys = ps[starts]
    return (
        (keys >> 32).astype(np.int32),
        (keys & np.int64(0xFFFFFFFF)).astype(np.int32),
        (wmax >> 32).astype(np.int32),
        (wmax & np.int64(0xFFFFFFFF)).astype(np.int32),
    )


# ------------------------------------------------------ host rank index


class RankIndex:
    """Gap ranks over the distinct (cls, khi, klo) triples, indexed by vid.

    The host-side order authority for the rank layouts: every interned vid
    gets a 31-bit rank strictly monotone in its (cls, khi, klo, vid) key.
    New keys land in the gap between their sorted neighbours (a batch
    landing in one gap spreads evenly across it); when a gap is exhausted
    the whole space respreads evenly, ``needs_rekey`` flags the device
    tables for a re-gather, and ``prev_inverse`` keeps the pre-respread
    (sorted ranks, vids) that a rank1 table needs to decode its stale
    ranks.

    On a mesh of processes every process holds its own copy, fed the same
    puts in the same order; the index is a pure function of that
    sequence, so every process takes the same respreads at the same puts
    (tests/test_torch_multihost.py compares the copies).

    Keys are stored as two fused int64 columns (k1 = cls * 2^32 | khi_u,
    k2 = klo_u; the bias-mapped unsigned halves recombine order-exactly),
    so an insert position is a searchsorted on k1 refined within the
    equal-k1 run."""

    _BIAS = np.int64(1) << 31

    def __init__(self) -> None:
        self._rank_of = np.zeros(0, dtype=np.int64)  # by vid
        self._svids = np.zeros(0, dtype=np.int64)  # vids sorted by key
        self._sranks = np.zeros(0, dtype=np.int64)  # ranks in svids order
        self._sk1 = np.zeros(0, dtype=np.int64)
        self._sk2 = np.zeros(0, dtype=np.int64)
        self.needs_rekey = False
        self.epoch = 0  # bumped on every respread
        # alternating output pools for the native sort-merge (_merge_scratch)
        self._scratch = [None, None]
        self._scratch_i = 0
        # (sorted ranks, vids) as of the moment the last respread fired;
        # None until the first respread over a non-empty index
        self.prev_inverse: "tuple[np.ndarray, np.ndarray] | None" = None

    def __len__(self) -> int:
        return len(self._svids)

    def _fuse(self, cls, khi, klo):
        cls = np.asarray(cls, dtype=np.int64)
        khi = np.asarray(khi, dtype=np.int64)
        klo = np.asarray(klo, dtype=np.int64)
        return (cls << 32) | (khi + self._BIAS), klo + self._BIAS

    def rank_map(self, dtype=np.int32) -> np.ndarray:
        """vid -> rank LUT for device conversion and re-keying."""
        return self._rank_of.astype(dtype)

    def rank_of(self, vid: int) -> int:
        return int(self._rank_of[vid])

    def inverse_arrays(self, dtype=np.int32):
        """(sorted live ranks, matching vids): the rank -> vid inverse of
        the rank1 layout (ranks increase along the key-sorted vids)."""
        return self._sranks.astype(dtype), self._svids.astype(dtype)

    def rank_bounds(self, cls, lo_khi, lo_klo, hi_khi, hi_klo):
        """(lo_rank, hi_rank) covering exactly the ranked vids whose
        (cls, khi, klo) key lies in the inclusive key interval: the rank1
        layout's range-query bounds (ranks are lexicographic in the keys,
        so the matching vids form one contiguous rank run). None if the
        interval holds no ranked vid. Bounds need not be interned."""
        k1lo, k2lo = self._fuse(cls, lo_khi, lo_klo)
        k1hi, k2hi = self._fuse(cls, hi_khi, hi_klo)
        # first stored key >= lo
        p = int(np.searchsorted(self._sk1, k1lo, side="left"))
        q = int(np.searchsorted(self._sk1, k1lo, side="right"))
        if p != q:  # refine within the equal-k1 run
            p += int(np.searchsorted(self._sk2[p:q], k2lo, side="left"))
        # last stored key <= hi (exclusive upper position)
        r = int(np.searchsorted(self._sk1, k1hi, side="left"))
        s = int(np.searchsorted(self._sk1, k1hi, side="right"))
        if r != s:
            r += int(np.searchsorted(self._sk2[r:s], k2hi, side="right"))
        else:
            r = s
        if p >= r:
            return None
        return int(self._sranks[p]), int(self._sranks[r - 1])

    def decode_ranks(self, ranks: np.ndarray) -> np.ndarray:
        """Host-side rank -> vid decode (current epoch). Rank 0 (absent)
        and any rank with no exact inverse entry decode to -1: a stale rank
        reads as absent, never as a nearby wrong vid."""
        ranks = np.asarray(ranks, dtype=np.int64)
        if len(self._svids) == 0:
            return np.full(ranks.shape, -1, dtype=np.int64)
        idx = np.clip(np.searchsorted(self._sranks, ranks), 0, len(self._svids) - 1)
        hit = (ranks > 0) & (self._sranks[idx] == ranks)
        return np.where(hit, self._svids[idx], -1)

    def _merge_scratch(self, need: int):
        """Alternating persistent output pools for the native sort-merge:
        the merged arrays a call produces become the stored index (views
        into the pool) and the next insert reads them as inputs, so the two
        pools alternate and inputs never alias outputs. Grown by doubling."""
        self._scratch_i ^= 1
        bufs = self._scratch[self._scratch_i]
        if bufs is None or len(bufs[0]) < need:
            cap = max(2 * need, 2 * (len(bufs[0]) if bufs else 0))
            bufs = tuple(np.empty(cap, dtype=np.int64) for _ in range(4))
            self._scratch[self._scratch_i] = bufs
        return bufs

    def _respread(self) -> None:
        # RANK_SPAN is read at call time: tests shrink it to force respreads
        n = len(self._svids)
        gap = RANK_SPAN // (n + 1)
        ranks = np.arange(1, n + 1, dtype=np.int64) * gap
        self._rank_of[self._svids] = ranks
        self._sranks = ranks
        self.needs_rekey = True
        self.epoch += 1

    def refresh_keys(self, cls_map, khi_map, klo_map) -> None:
        """Re-read every stored key from the interner's tables (after a
        string-rank rebalance: the bits moved, the order of existing vids
        did not, so every rank stays valid)."""
        self._sk1, self._sk2 = self._fuse(
            cls_map[self._svids], khi_map[self._svids], klo_map[self._svids]
        )

    def insert_batch(self, vids, cls, khi, klo) -> None:
        """Assign ranks to new vids with keys (cls, khi, klo). Vids must be
        new and higher than every ranked vid (the interner assigns them
        append-only). Equal keys insert after the existing equal-key run and
        sort by vid within a batch, so rank order is (cls, khi, klo, vid)
        order exactly."""
        vids = np.asarray(vids, dtype=np.int64)
        if vids.size == 0:
            return
        need = int(vids.max()) + 1
        if need > len(self._rank_of):
            grown = np.zeros(max(need, 2 * len(self._rank_of)), dtype=np.int64)
            grown[: len(self._rank_of)] = self._rank_of
            self._rank_of = grown

        if len(self._svids) == 0:
            k1, k2 = self._fuse(cls, khi, klo)
            order = np.lexsort((vids, k2, k1))
            self._svids = vids[order]
            self._sk1, self._sk2 = k1[order], k2[order]
            self._respread()
            # a fresh index has nothing on the device to re-key
            self.needs_rekey = False
            return

        # the pre-insert inverse: if this batch respreads, a rank1 table
        # still holds these ranks (no insert path mutates _sranks in place)
        old_svids = self._svids
        old_ranks = self._sranks

        from .. import native

        nat = None
        if native.load() is not None:
            nat = native.rank_insert_batch(
                self._sk1, self._sk2, old_svids, old_ranks,
                cls, khi, klo, vids, self._BIAS, RANK_SPAN,
                out=self._merge_scratch(len(old_svids) + vids.size),
            )
        if nat is not None:
            m_k1, m_k2, m_svids, m_sranks, new_ranks, need_respread = nat
            self._sk1, self._sk2, self._svids = m_k1, m_k2, m_svids
            self._sranks = m_sranks
            self._rank_of[vids] = new_ranks
            if need_respread:
                self._respread()
                self.prev_inverse = (old_ranks.astype(np.int32), old_svids.astype(np.int32))
            return

        k1, k2 = self._fuse(cls, khi, klo)
        # insert position of each new key (side='right': after the equal run)
        left = np.searchsorted(self._sk1, k1, side="left")
        pos = np.searchsorted(self._sk1, k1, side="right")
        collide = left != pos
        if np.any(collide):
            # refine within the equal-k1 run: run_id * 2^32 + k2 is globally
            # sorted over the stored keys, so one searchsorted gives the
            # absolute position
            m = len(self._sk1)
            new_run = np.empty(m, dtype=bool)
            new_run[0] = True
            np.not_equal(self._sk1[1:], self._sk1[:-1], out=new_run[1:])
            run_id = np.cumsum(new_run, dtype=np.int64) - 1
            enc_stored = (run_id << 32) | self._sk2
            enc_q = (run_id[left[collide]] << 32) | k2[collide]
            pos[collide] = np.searchsorted(enc_stored, enc_q, side="right")
        order = np.lexsort((vids, k2, k1, pos))
        pos, k1, k2, vids = pos[order], k1[order], k2[order], vids[order]

        ranks_sorted = self._sranks
        lo_rank = np.where(pos > 0, ranks_sorted[np.maximum(pos - 1, 0)], 0)
        hi_rank = np.where(
            pos < len(ranks_sorted),
            ranks_sorted[np.minimum(pos, len(ranks_sorted) - 1)],
            RANK_SPAN,
        )
        # the i-th of g items in gap (lo, hi) gets lo + (hi - lo)(i + 1)/(g + 1)
        first = np.empty(pos.size, dtype=bool)
        first[0] = True
        np.not_equal(pos[1:], pos[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        sizes = np.diff(np.append(starts, pos.size))
        within = np.arange(pos.size, dtype=np.int64) - np.repeat(starts, sizes)
        g = np.repeat(sizes, sizes).astype(np.int64)
        new_ranks = lo_rank + (hi_rank - lo_rank) * (within + 1) // (g + 1)

        self._svids = np.insert(self._svids, pos, vids)
        self._sk1 = np.insert(self._sk1, pos, k1)
        self._sk2 = np.insert(self._sk2, pos, k2)
        self._sranks = np.insert(self._sranks, pos, new_ranks)
        self._rank_of[vids] = new_ranks

        # a collision with a neighbour rank means the gap was exhausted
        all_ranks = self._sranks
        if np.any(all_ranks[1:] <= all_ranks[:-1]) or all_ranks[0] < 1:
            self._respread()
            self.prev_inverse = (old_ranks.astype(np.int32), old_svids.astype(np.int32))
