"""Leaf-value encoding: JSON values -> dense int32 order keys + intern ids.

The engine's CRT merge (see DESIGN.md) is a lexicographic max over
``(cls, khi, klo, vid, ...)``; this module defines that order. It is a
*documented total order* standing in for the reference's non-total JS ``<``
comparator (bullet-js src/bullet-crt.js:11-15): numbers keep exact
float64 ordering via the sign-flip bit trick, strings keep lexicographic
ordering via a gap-ranked order index, and opaque values (arrays) get a
deterministic insertion order.

Everything is host-side; the device only ever sees int32s.

The port's own copy of ``bullet_tpu/utils/encode.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import json
import math
import struct
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

# value classes (the ``cls`` array); order defines cross-type ordering
CLS_ABSENT = 0  # empty table slot: loses to every real value
CLS_NULL = 1
CLS_NUMBER = 2  # numbers and booleans (JS coerces bools in comparisons)
CLS_STRING = 3
CLS_OPAQUE = 4  # arrays (leaf values) and anything non-JSON-scalar

VID_ABSENT = 0
VID_NULL = 1

_INT32_BIAS = 1 << 31
_MASK64 = (1 << 64) - 1
_CANONICAL_NAN_BITS = 0xFFF8000000000000  # above +inf after the sign trick
_RAW_NAN_BITS = 0x7FF8000000000000  # canonical qNaN (pre-transform identity)

RANK_BITS = 62
RANK_SPACE = 1 << RANK_BITS


def _u32_to_i32(u: int) -> int:
    """Map uint32 -> int32 preserving order (subtract bias)."""
    return int(u) - _INT32_BIAS


def number_key(v: float) -> Tuple[int, int]:
    """Order-preserving (khi, klo) int32 pair for a float64.

    Standard trick: flip all bits of negatives, set the sign bit of
    non-negatives; the resulting uint64 compares like the float. NaN is
    canonicalized above +inf; -0.0 is canonicalized to 0.0 (JS ``===``
    identifies them).
    """
    f = float(v)
    if math.isnan(f):
        bits = _CANONICAL_NAN_BITS
    else:
        if f == 0.0:
            f = 0.0  # collapse -0.0
        bits = struct.unpack("<Q", struct.pack("<d", f))[0]
        if bits >> 63:
            bits = (~bits) & _MASK64
        else:
            bits |= 1 << 63
    return _u32_to_i32(bits >> 32), _u32_to_i32(bits & 0xFFFFFFFF)


def rank_key(rank: int) -> Tuple[int, int]:
    """(khi, klo) for a 62-bit order rank (strings, opaque ids)."""
    return _u32_to_i32(rank >> 31), _u32_to_i32(rank & 0x7FFFFFFF)


class StringOrderIndex:
    """Assigns each string a rank in [0, 2^62) preserving JS string order
    (UTF-16 code-unit comparison — see ``jsvalues.utf16_key``).

    New strings get the midpoint of their neighbors' ranks; when adjacent
    ranks run out of gap, every rank is respread evenly (a "rebalance") and
    the caller must re-derive keys for previously encoded strings (the
    ValueInterner handles that and exposes an epoch counter).
    """

    def __init__(self) -> None:
        self._sorted: List[bytes] = []
        self._rank: Dict[bytes, int] = {}
        self.rebalances = 0

    def rank(self, s: str) -> int:
        from .jsvalues import utf16_key

        return self._rank[utf16_key(s)]

    def insert(self, raw: str) -> Tuple[int, bool]:
        """Return (rank, rebalanced). Idempotent for known strings."""
        from .jsvalues import utf16_key

        s = utf16_key(raw)
        existing = self._rank.get(s)
        if existing is not None:
            return existing, False
        idx = bisect.bisect_left(self._sorted, s)
        lo = self._rank[self._sorted[idx - 1]] if idx > 0 else -1
        hi = self._rank[self._sorted[idx]] if idx < len(self._sorted) else RANK_SPACE
        rebalanced = False
        if hi - lo < 2:
            self._sorted.insert(idx, s)
            self._respread()
            rebalanced = True
        else:
            rank = (lo + hi) // 2
            self._rank[s] = rank
            self._sorted.insert(idx, s)
        self.rebalances += int(rebalanced)
        return self._rank[s], rebalanced

    def _respread(self) -> None:
        n = len(self._sorted)
        gap = RANK_SPACE // (n + 1)
        for i, s in enumerate(self._sorted):
            self._rank[s] = (i + 1) * gap

    def insert_batch(self, strings) -> Tuple[np.ndarray, int]:
        """Insert many strings in order; returns (final ranks u64 array,
        respread count) — same contract as the native index's batch API."""
        reb = 0
        for s in strings:
            _, r = self.insert(s)
            reb += int(r)
        return self.rank_batch(strings), reb

    def rank_batch(self, strings) -> np.ndarray:
        from .jsvalues import utf16_key

        return np.fromiter(
            (self._rank[utf16_key(s)] for s in strings),
            dtype=np.uint64,
            count=len(strings),
        )


class _I32Col:
    """Growable int32 column (amortized-doubling numpy storage).

    Replaces per-vid Python lists in the interner: bulk ingestion extends
    with one vectorized copy instead of a million tolist/append steps, and
    ``view()`` exports the live prefix without re-materializing an array.
    """

    __slots__ = ("a", "n")

    def __init__(self, cap: int = 1024) -> None:
        self.a = np.empty(cap, dtype=np.int32)
        self.n = 0

    def _grow(self, need: int) -> None:
        cap = max(len(self.a) * 2, need)
        na = np.empty(cap, dtype=np.int32)
        na[: self.n] = self.a[: self.n]
        self.a = na

    def append(self, v: int) -> None:
        if self.n == len(self.a):
            self._grow(self.n + 1)
        self.a[self.n] = v
        self.n += 1

    def extend_np(self, arr: np.ndarray) -> None:
        need = self.n + len(arr)
        if need > len(self.a):
            self._grow(need)
        self.a[self.n : need] = arr
        self.n = need

    def __getitem__(self, i: int) -> int:
        return int(self.a[i])

    def __setitem__(self, i: int, v: int) -> None:
        self.a[i] = v

    def view(self) -> np.ndarray:
        return self.a[: self.n]


class _Lazy:
    """Sentinel marking a number vid whose Python value has not been
    materialized; ``decode`` reconstructs it from the (khi, klo) order key
    (the sign-flip transform is bijective, so no extra storage is needed)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<lazy number>"


_LAZY = _Lazy()


class ValueInterner:
    """Global value <-> vid map plus per-vid order keys.

    One interner is shared across all simulated peers so equal values have
    equal ids (and thus merge deterministically) everywhere. ``key_table()``
    exports per-vid (cls, khi, klo) numpy arrays so device tables can be
    re-keyed with a single gather after a string-rank rebalance.
    """

    def __init__(self) -> None:
        self._vid_of: Dict[Any, int] = {}
        self._value_of: List[Any] = []
        self._cls = _I32Col()
        self._khi = _I32Col()
        self._klo = _I32Col()
        from ..native import make_number_interner, make_string_order_index

        # native C++ order-statistic index when the toolchain is available;
        # it is fed UTF-16-BE byte keys, whose byte order matches JS UTF-16
        # code-unit comparison (the project-wide string order — NOT codepoint
        # order, which differs for astral-plane strings); the pure-Python
        # StringOrderIndex otherwise
        self._strings = make_string_order_index()
        # numbers intern through a bits->vid map (native when available)
        # instead of the token dict, enabling batch interning
        self._numbers = make_number_interner()
        self.epoch = 0  # bumped on every string-rank rebalance
        self._on_rebalance: List[Callable[[], None]] = []
        # vid 0 = absent, vid 1 = null
        self._push(("absent",), None, CLS_ABSENT, -_INT32_BIAS, -_INT32_BIAS)
        self._push(("null",), None, CLS_NULL, 0, 0)

    def _push(self, token, value, cls, khi, klo) -> int:
        vid = len(self._value_of)
        self._vid_of[token] = vid
        self._value_of.append(value)
        self._cls.append(cls)
        self._khi.append(khi)
        self._klo.append(klo)
        return vid

    def on_rebalance(self, fn: Callable[[], None]) -> None:
        self._on_rebalance.append(fn)

    def __len__(self) -> int:
        return len(self._value_of)

    @staticmethod
    def _token(value: Any):
        if value is None:
            return ("null",)
        if isinstance(value, bool):
            return ("bool", value)
        if isinstance(value, str):
            return ("str", value)
        if isinstance(value, list):
            return ("arr", json.dumps(value, sort_keys=True, default=str))
        raise TypeError(f"not a leaf value: {type(value)!r}")

    @staticmethod
    def _raw_bits(f: float) -> int:
        """Identity bits of a canonicalized float64 (the bits->vid map key)."""
        if math.isnan(f):
            return _RAW_NAN_BITS
        if f == 0.0:
            f = 0.0
        return struct.unpack("<Q", struct.pack("<d", f))[0]

    @staticmethod
    def _canonical_number(f: float) -> Any:
        """The CANONICAL stored form: integral floats as int, -0.0 as 0 —
        decode() must not depend on whether the scalar or the bulk path
        interned the value first; matches JSON.stringify(5.0) === "5"."""
        if f == 0.0:
            return 0
        if math.isfinite(f) and f.is_integer() and abs(f) < 2**63:
            return int(f)
        return f

    def _materialize_number(self, vid: int) -> Any:
        """Reconstruct a lazily-stored number from its (khi, klo) order key
        by inverting the sign-flip transform of ``number_key``."""
        u = ((self._khi[vid] + _INT32_BIAS) << 32) | (self._klo[vid] + _INT32_BIAS)
        if u >> 63:
            u &= _MASK64 >> 1  # was non-negative: clear the forced sign bit
        else:
            u = (~u) & _MASK64  # was negative: un-flip all bits
        return self._canonical_number(struct.unpack("<d", struct.pack("<Q", u))[0])

    def encode(self, value: Any) -> Tuple[int, int, int, int]:
        """Intern ``value`` and return (cls, khi, klo, vid)."""
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            f = to_float(value)
            bits = self._raw_bits(f)
            vid = self._numbers.lookup(bits)
            if vid is None:
                khi, klo = number_key(f)
                vid = len(self._value_of)
                self._value_of.append(self._canonical_number(f))
                self._cls.append(CLS_NUMBER)
                self._khi.append(khi)
                self._klo.append(klo)
                self._numbers.insert(bits, vid)
            return self._cls[vid], self._khi[vid], self._klo[vid], vid
        token = self._token(value)
        vid = self._vid_of.get(token)
        if vid is not None:
            return self._cls[vid], self._khi[vid], self._klo[vid], vid
        if token[0] == "bool":
            khi, klo = number_key(to_float(value))
            vid = self._push(token, value, CLS_NUMBER, khi, klo)
        elif token[0] == "str":
            rank, rebalanced = self._strings.insert(value)
            if rebalanced:
                self._rekey_strings()
            khi, klo = rank_key(rank)
            vid = self._push(token, value, CLS_STRING, khi, klo)
            if rebalanced:
                self.epoch += 1
                for fn in self._on_rebalance:
                    fn()
        else:  # opaque: order = insertion order (deterministic-arbitrary)
            vid = len(self._value_of)
            khi, klo = rank_key(vid)
            vid = self._push(token, value, CLS_OPAQUE, khi, klo)
        return self._cls[vid], self._khi[vid], self._klo[vid], vid

    def _rekey_strings(self) -> None:
        idxs = np.nonzero(self._cls.view() == CLS_STRING)[0]
        if not len(idxs):
            return
        ranks = self._strings.rank_batch(
            [self._value_of[i] for i in idxs.tolist()]
        )
        khi, klo = rank_keys_np(ranks)
        self._khi.view()[idxs] = khi
        self._klo.view()[idxs] = klo

    def decode(self, vid: int) -> Any:
        v = self._value_of[vid]
        if v is _LAZY:
            v = self._materialize_number(vid)
            self._value_of[vid] = v  # memoize
        return v

    def decode_batch(self, vids) -> np.ndarray:
        """Vectorized ``decode`` over a vid array → object ndarray (same
        values and memoization). Lazily-stored numbers materialize in one
        numpy pass over their (khi, klo) keys instead of per-vid struct
        pack/unpack (which cost ~0.4 s per 100k reads in get_bulk)."""
        vids_l = np.asarray(vids, dtype=np.int64).tolist()
        vals = self._value_of
        out = np.empty(len(vids_l), dtype=object)
        lazy_pos = []
        for i, v in enumerate(vids_l):
            s = vals[v]
            if s is _LAZY:
                lazy_pos.append(i)
            else:
                out[i] = s
        if lazy_pos:
            lv = np.asarray([vids_l[i] for i in lazy_pos], dtype=np.int64)
            khi = self._khi.view()[lv].astype(np.int64)
            klo = self._klo.view()[lv].astype(np.int64)
            u = (
                ((khi + _INT32_BIAS) << 32) | (klo + _INT32_BIAS)
            ).astype(np.uint64)
            # invert number_key's sign-flip transform (_materialize_number)
            u = np.where(
                (u >> np.uint64(63)) != 0,
                u & np.uint64(_MASK64 >> 1),
                ~u,
            )
            f = u.view(np.float64)
            # _canonical_number: integral finite |f| < 2^63 → int (covers
            # ±0.0 → 0); everything else stays float (NaN/inf included)
            finite = np.isfinite(f)
            is_int = np.zeros(len(f), dtype=bool)
            is_int[finite] = (f[finite] == np.floor(f[finite])) & (
                np.abs(f[finite]) < 2.0**63
            )
            fl = f.tolist()
            ii = is_int.tolist()
            for j, i in enumerate(lazy_pos):
                v = int(fl[j]) if ii[j] else fl[j]
                out[i] = v
                vals[vids_l[i]] = v  # memoize, like decode()
        return out

    def key_of(self, vid: int) -> Tuple[int, int, int]:
        return self._cls[vid], self._khi[vid], self._klo[vid]

    def key_table(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cls, khi, klo) arrays indexed by vid, for device re-keying.

        Copies: the interner keeps mutating its columns (appends, string
        re-keying) after export."""
        return (
            self._cls.view().copy(),
            self._khi.view().copy(),
            self._klo.view().copy(),
        )


def to_float(value: Any) -> float:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    return float(value)


# ------------------------------------------------------------- bulk (numpy)


def number_keys_np(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``number_key``: float64 array -> (khi, klo) int32 arrays.

    Same canonicalizations as the scalar path: -0.0 collapses to 0.0, NaN to
    a fixed pattern above +inf.
    """
    f = np.asarray(values, dtype=np.float64).copy()
    f[f == 0.0] = 0.0  # collapse -0.0
    bits = f.view(np.uint64).copy()
    bits[np.isnan(f)] = np.uint64(_CANONICAL_NAN_BITS)
    neg = (bits >> np.uint64(63)) != 0
    nan_mask = np.isnan(f)
    flip = neg & ~nan_mask
    bits[flip] = ~bits[flip]
    bits[~neg] |= np.uint64(1) << np.uint64(63)
    khi = ((bits >> np.uint64(32)).astype(np.int64) - _INT32_BIAS).astype(np.int32)
    klo = ((bits & np.uint64(0xFFFFFFFF)).astype(np.int64) - _INT32_BIAS).astype(
        np.int32
    )
    return khi, klo


def bulk_encode_numbers(
    interner: "ValueInterner", values: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized encode of a numeric array: (cls, khi, klo, vid) int32
    arrays. Interning runs through the (native) bits->vid batch map —
    no per-value Python work beyond a list-extend for first occurrences.
    The key transform prefers the native one-pass bk_number_keys (keys +
    canonical intern bits together, no large temps); the numpy path is
    the bit-identical fallback."""
    from .. import native

    values = np.asarray(values, dtype=np.float64)
    fast = native.number_keys(values)
    if fast is not None:
        khi_flat, klo_flat, bits_flat = fast
        khi = khi_flat.reshape(values.shape)
        klo = klo_flat.reshape(values.shape)
        bits = bits_flat
    else:
        khi, klo = number_keys_np(values)
        f = values.copy()
        f[f == 0.0] = 0.0
        b = f.view(np.uint64).copy()
        b[np.isnan(f)] = np.uint64(_RAW_NAN_BITS)
        bits = b
    vids, new_idx = interner._numbers.intern_batch(
        bits.ravel(), len(interner._value_of)
    )
    if len(new_idx):
        n_new = len(new_idx)
        # Python values materialize lazily on decode() (from the order key,
        # which is bijective) — building a million int/float objects up
        # front cost ~0.45 s per 1M novel values (the ingest hot path)
        interner._value_of.extend([_LAZY] * n_new)
        interner._cls.extend_np(np.full(n_new, CLS_NUMBER, dtype=np.int32))
        interner._khi.extend_np(khi.ravel()[new_idx])
        interner._klo.extend_np(klo.ravel()[new_idx])
    vid = vids.reshape(values.shape).astype(np.int32)
    cls = np.full(values.shape, CLS_NUMBER, dtype=np.int32)
    return cls, khi, klo, vid


def rank_keys_np(ranks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``rank_key``: u64 rank array -> (khi, klo) int32 arrays."""
    r = np.asarray(ranks, dtype=np.uint64)
    khi = ((r >> np.uint64(31)).astype(np.int64) - _INT32_BIAS).astype(np.int32)
    klo = ((r & np.uint64(0x7FFFFFFF)).astype(np.int64) - _INT32_BIAS).astype(
        np.int32
    )
    return khi, klo


def bulk_encode_strings(
    interner: "ValueInterner", values
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized encode of a list of strings: novel strings go through ONE
    native batch insert (rank/respread sequence bit-identical to sequential
    scalar encodes; final ranks are fetched post-respread)."""
    n = len(values)
    vid = np.empty(n, dtype=np.int64)
    vid_of = interner._vid_of
    base = len(interner._value_of)
    novel: List[str] = []
    pending: Dict[str, int] = {}
    for i, s in enumerate(values):
        v = vid_of.get(("str", s))
        if v is None:
            v = pending.get(s)
            if v is None:
                v = base + len(novel)
                pending[s] = v
                novel.append(s)
        vid[i] = v
    if novel:
        ranks, reb = interner._strings.insert_batch(novel)
        if reb:
            # previously interned strings may have moved: re-key them BEFORE
            # appending the new vids (the scan walks current CLS_STRING vids)
            interner._rekey_strings()
        khi_n, klo_n = rank_keys_np(ranks)
        for s in novel:
            vid_of[("str", s)] = pending[s]
        interner._value_of.extend(novel)
        interner._cls.extend_np(
            np.full(len(novel), CLS_STRING, dtype=np.int32)
        )
        interner._khi.extend_np(khi_n)
        interner._klo.extend_np(klo_n)
        if reb:
            interner.epoch += reb
            for fn in interner._on_rebalance:
                fn()
    vid = vid.astype(np.int32)
    cls = np.full(n, CLS_STRING, dtype=np.int32)
    return cls, interner._khi.view()[vid], interner._klo.view()[vid], vid


# leaf-class dispatch cache for bulk_encode_values: exact type -> 0 (number,
# excluding bool) / 1 (string) / 2 (scalar path). A dict lookup on
# ``v.__class__`` is ~4x cheaper than the isinstance chain at 1M values;
# subclasses resolve once (bool first — it subclasses int).
_CLS_KIND: Dict[type, int] = {int: 0, float: 0, str: 1, bool: 2}


def _leaf_kind(t: type) -> int:
    if issubclass(t, bool):
        return 2
    if issubclass(t, (int, float)):
        return 0
    if issubclass(t, str):
        return 1
    return 2


def bulk_encode_values(
    interner: "ValueInterner", values
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode ANY sequence of leaf values to (cls, khi, klo, vid) int32
    arrays: numbers and strings take the vectorized batch paths, everything
    else (null/bool/array) the scalar path. Within one batch, vids are
    assigned numbers-first, then strings, then the rest in encounter order
    (the interner's opaque ordering is documented deterministic-arbitrary,
    and relative order within each class is preserved).

    Homogeneous batches skip per-element classification entirely: ONE
    C-level type-set pass (~25x cheaper than classifying) detects
    all-numbers / all-strings lists — the common bulk-load shapes — and
    routes them straight to the batch encoder. The exact-type set is safe
    against the silent-coercion trap that bans np.asarray on mixed lists:
    bool is its own __class__, so a stray True can never reach the
    numeric path."""
    n = len(values)
    kinds = {v.__class__ for v in values}
    if kinds and kinds <= {int, float}:
        return bulk_encode_numbers(
            interner, np.asarray(values, dtype=np.float64)
        )
    if kinds == {str}:
        return bulk_encode_strings(interner, values)
    cls = np.empty(n, dtype=np.int32)
    khi = np.empty(n, dtype=np.int32)
    klo = np.empty(n, dtype=np.int32)
    vid = np.empty(n, dtype=np.int32)
    num_idx: List[int] = []
    str_idx: List[int] = []
    rest_idx: List[int] = []
    nums: List[float] = []
    strs: List[str] = []
    kind_of = _CLS_KIND.get
    for i, v in enumerate(values):
        k = kind_of(v.__class__)
        if k is None:
            k = _CLS_KIND[v.__class__] = _leaf_kind(v.__class__)
        if k == 0:
            num_idx.append(i)
            nums.append(v)
        elif k == 1:
            str_idx.append(i)
            strs.append(v)
        else:
            rest_idx.append(i)
    if nums:
        c, h, l, d = bulk_encode_numbers(
            interner, np.asarray(nums, dtype=np.float64)
        )
        idx = np.asarray(num_idx)
        cls[idx], khi[idx], klo[idx], vid[idx] = c, h, l, d
    if strs:
        c, h, l, d = bulk_encode_strings(interner, strs)
        idx = np.asarray(str_idx)
        cls[idx], khi[idx], klo[idx], vid[idx] = c, h, l, d
    for i in rest_idx:
        cls[i], khi[i], klo[i], vid[i] = interner.encode(values[i])
    return cls, khi, klo, vid
