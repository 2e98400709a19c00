"""Traced query predicates: the port of ``bullet_tpu.ops.predicates``.

The reference's ``filter``/``find``/``count`` take an arbitrary JS callback
and run a full host scan over the children of a path (bullet-js
``src/bullet-query.js``). The engine keeps that host-callable fallback,
but for the structured predicates real queries are made of -- field
comparisons composed with and/or/not -- this module compiles the predicate
TREE into one mask program over a peer's row, so a filter over a 1M-row
subtree never decodes values to the host.

DSL::

    from bullet_tpu_torch import P
    sim.filter(0, "users", (P["age"] > 25) & (P["role"] == "user"))
    sim.count(0, "users", ~P.has("email"))
    sim.filter(0, "scores", P.value() >= 90)        # leaf-form children

Semantics (JS-flavored, and identical between the device program and
``evaluate`` -- the host oracle the tests fuzz against):

- ``P["f"] OP v`` is False when the child has no scalar leaf ``f`` (JS:
  ``undefined > 25`` -> false). Negation happens at the child level, so
  ``~(P["f"] > v)`` INCLUDES children missing ``f`` (JS: ``!(undefined >
  25)`` -> true).
- Comparisons (< <= > >=) are numeric-class only; booleans coerce like JS
  (``true > 0``); NaN never compares; strings/objects never match a
  numeric comparison (the engine's ``range`` is numeric-only too).
- ``==`` is encoded-value identity, the same identity ``equals`` uses:
  ``1 == 1.0`` (one number vid) but ``True != 1`` (bool vids are distinct
  even though they ORDER like numbers), and all NaNs are one value.
  ``== None`` matches nothing: null leaves decode as absent everywhere in
  the engine.
- ``P.has("f")`` -- child has a live scalar leaf ``f`` (nulls and whole
  subtrees don't count; mirrors how decoded trees omit nulls).

Evaluation maps each atom to a slot mask (compares over the peer's row),
scatters slot masks to child-level booleans, combines the static tree, and
intersects with ``parent == base``. The host half (the AST, ``evaluate``,
the key intervals, ``predicate_params``) is the reference's, copied; the
reference jit-compiles the program per tree shape, and the port keeps one
Python program per tree shape (``compile_predicate``), whose PyTorch
operators run where the row lives. Probe values ride in ``params`` as
int32 scalars, so re-querying with new constants builds nothing.
"""

from __future__ import annotations

import json
import math
from typing import Any, Iterator, List, Optional, Tuple

import torch

from ..utils.encode import (
    CLS_ABSENT,
    CLS_NUMBER,
    VID_NULL,
    number_key,
    to_float,
)

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1
_EMPTY_RANGE = (_I32_MAX, _I32_MAX, _I32_MIN, _I32_MIN)  # lo > hi: no match
_MISSING = object()


# --------------------------------------------------------------------- AST


class Predicate:
    """Base predicate node: composable with ``&``, ``|``, ``~``."""

    def __and__(self, other: "Predicate") -> "Predicate":
        return _And(self, _as_pred(other))

    def __or__(self, other: "Predicate") -> "Predicate":
        return _Or(self, _as_pred(other))

    def __invert__(self) -> "Predicate":
        return _Not(self)

    def __rand__(self, other):
        return _And(_as_pred(other), self)

    def __ror__(self, other):
        return _Or(_as_pred(other), self)

    def __bool__(self):
        raise TypeError(
            "Predicate has no truth value — combine with & | ~ (not and/or)"
        )

    # -- interface implemented by subclasses
    def signature(self) -> str:
        raise NotImplementedError

    def atoms(self) -> Iterator["_Atom"]:
        raise NotImplementedError

    def evaluate(self, value: Any) -> bool:
        """Host-side oracle: evaluate against one decoded child value."""
        raise NotImplementedError


def _as_pred(p) -> Predicate:
    if not isinstance(p, Predicate):
        raise TypeError(f"expected a Predicate, got {type(p).__name__}")
    return p


class _And(Predicate):
    def __init__(self, a: Predicate, b: Predicate) -> None:
        self.a, self.b = a, b

    def signature(self) -> str:
        return f"({self.a.signature()}&{self.b.signature()})"

    def atoms(self):
        yield from self.a.atoms()
        yield from self.b.atoms()

    def evaluate(self, value):
        return self.a.evaluate(value) and self.b.evaluate(value)


class _Or(Predicate):
    def __init__(self, a: Predicate, b: Predicate) -> None:
        self.a, self.b = a, b

    def signature(self) -> str:
        return f"({self.a.signature()}|{self.b.signature()})"

    def atoms(self):
        yield from self.a.atoms()
        yield from self.b.atoms()

    def evaluate(self, value):
        return self.a.evaluate(value) or self.b.evaluate(value)


class _Not(Predicate):
    def __init__(self, a: Predicate) -> None:
        self.a = a

    def signature(self) -> str:
        return f"!{self.a.signature()}"

    def atoms(self):
        yield from self.a.atoms()

    def evaluate(self, value):
        return not self.a.evaluate(value)


class _Atom(Predicate):
    """Leaf node bound to one field (or the child value itself)."""

    kind: str  # "eq" | "rng" | "ex"

    def __init__(self, field: Optional[str]) -> None:
        self.field = field  # None = leaf form (the child value itself)

    def atoms(self):
        yield self

    def signature(self) -> str:
        return self.kind + ("L" if self.field is None else "F")

    def _operand(self, value: Any):
        """The value this atom tests: the named field or the child itself.
        Returns _MISSING when there is no scalar leaf to test (missing
        field, nested object — those have no leaf slot on device)."""
        if self.field is None:
            x = value
        elif isinstance(value, dict):
            x = value.get(self.field, _MISSING)
        else:
            x = _MISSING
        if isinstance(x, dict) or x is None:
            return _MISSING  # subtrees have no leaf slot; nulls decode absent
        return x


class _Eq(_Atom):
    kind = "eq"

    def __init__(self, field: Optional[str], probe: Any) -> None:
        super().__init__(field)
        if isinstance(probe, dict):
            raise TypeError("== against an object is not a leaf comparison")
        self.probe = probe

    def evaluate(self, value):
        x = self._operand(value)
        if x is _MISSING:
            return False
        return _encoded_eq(x, self.probe)


class _Cmp(_Atom):
    """Numeric comparison, lowered to ONE inclusive key interval."""

    kind = "rng"
    _OPS = ("lt", "le", "gt", "ge", "between")

    def __init__(self, field, op: str, lo: Any, hi: Any = None) -> None:
        super().__init__(field)
        assert op in self._OPS
        self.op = op
        self.lo = lo
        self.hi = hi

    def evaluate(self, value):
        x = self._operand(value)
        if x is _MISSING or not isinstance(x, (int, float)):
            return False  # bool is an int subclass: coerces like JS
        fx = to_float(x)
        if self.op == "lt":
            return fx < to_float(self.lo)
        if self.op == "le":
            return fx <= to_float(self.lo)
        if self.op == "gt":
            return fx > to_float(self.lo)
        if self.op == "ge":
            return fx >= to_float(self.lo)
        return to_float(self.lo) <= fx <= to_float(self.hi)

    def key_interval(self) -> Tuple[int, int, int, int]:
        """Inclusive (lo_hi, lo_lo, hi_hi, hi_lo) key bounds equivalent to
        the comparison: strict bounds become the successor/predecessor key
        (keys totally order float64s, so > v ≡ ≥ succ(key(v))); one-sided
        bounds close with ±inf keys — NaN keys sort ABOVE key(+inf) in the
        encoding, so closing at key(inf) keeps NaN slots out of every
        interval, matching JS NaN comparison semantics."""
        lo_f = to_float(self.lo)
        hi_f = to_float(self.hi) if self.op == "between" else None
        if math.isnan(lo_f) or (hi_f is not None and math.isnan(hi_f)):
            return _EMPTY_RANGE
        if self.op == "lt":
            return (*number_key(float("-inf")), *_pred_key(*number_key(lo_f)))
        if self.op == "le":
            return (*number_key(float("-inf")), *number_key(lo_f))
        if self.op == "gt":
            return (*_succ_key(*number_key(lo_f)), *number_key(float("inf")))
        if self.op == "ge":
            return (*number_key(lo_f), *number_key(float("inf")))
        return (*number_key(lo_f), *number_key(hi_f))


class _Exists(_Atom):
    kind = "ex"

    def evaluate(self, value):
        return self._operand(value) is not _MISSING


def _succ_key(khi: int, klo: int) -> Tuple[int, int]:
    if klo == _I32_MAX:
        if khi == _I32_MAX:  # saturate: nothing sorts above this
            return _I32_MAX, _I32_MAX
        return khi + 1, _I32_MIN
    return khi, klo + 1


def _pred_key(khi: int, klo: int) -> Tuple[int, int]:
    if klo == _I32_MIN:
        if khi == _I32_MIN:
            return _I32_MIN, _I32_MIN
        return khi - 1, _I32_MAX
    return khi, klo - 1


def _encoded_eq(x: Any, probe: Any) -> bool:
    """Encoded-value identity: True iff ``encode(x)`` and ``encode(probe)``
    intern to the same vid (without interning anything)."""
    if isinstance(probe, bool) or isinstance(x, bool):
        return isinstance(x, bool) and isinstance(probe, bool) and x is probe
    if isinstance(probe, (int, float)):
        if not isinstance(x, (int, float)):
            return False
        fx, fp = to_float(x), to_float(probe)
        if math.isnan(fp) or math.isnan(fx):
            return math.isnan(fp) and math.isnan(fx)  # one NaN vid
        return fx == fp  # covers -0.0 == 0.0 (one canonical zero vid)
    if isinstance(probe, str):
        return isinstance(x, str) and x == probe
    if probe is None:
        return False  # nulls decode as absent: == None matches nothing
    if isinstance(probe, list):
        return isinstance(x, list) and json.dumps(
            x, sort_keys=True, default=str
        ) == json.dumps(probe, sort_keys=True, default=str)
    raise TypeError(f"unsupported probe type: {type(probe).__name__}")


# --------------------------------------------------------------- public DSL


class _Field:
    """Comparison factory for one field (or the leaf value itself)."""

    def __init__(self, name: Optional[str]) -> None:
        self._name = name

    def __eq__(self, other):  # type: ignore[override]
        return _Eq(self._name, other)

    def __ne__(self, other):  # type: ignore[override]
        # JS: u.f !== v is true when f is undefined — hence NOT(eq)
        return _Not(_Eq(self._name, other))

    def __lt__(self, other):
        return _Cmp(self._name, "lt", other)

    def __le__(self, other):
        return _Cmp(self._name, "le", other)

    def __gt__(self, other):
        return _Cmp(self._name, "gt", other)

    def __ge__(self, other):
        return _Cmp(self._name, "ge", other)

    def between(self, lo, hi) -> Predicate:
        """Inclusive numeric interval (the ``range`` query as an atom)."""
        return _Cmp(self._name, "between", lo, hi)

    def exists(self) -> Predicate:
        return _Exists(self._name)

    __hash__ = None  # comparison factory, not a value


class _PMeta(type):
    def __getitem__(cls, name: str) -> _Field:
        return _Field(str(name))


class P(metaclass=_PMeta):
    """Predicate entry point: ``P["field"]`` / ``P.value()`` / ``P.has``."""

    @staticmethod
    def value() -> _Field:
        """The child value itself (leaf-form children, e.g. ``scores/*``)."""
        return _Field(None)

    @staticmethod
    def has(field: str) -> Predicate:
        return _Exists(str(field))


# ----------------------------------------------------------- device compile

_COMPILED: dict = {}


def _child_level(slot_mask: torch.Tensor, safe_parent: torch.Tensor, n: int) -> torch.Tensor:
    """Slot mask -> child-level mask: a child is true iff one of its slots
    is (the reference's scatter-max), as a count of true slots per parent,
    which no order of the adds can change and which needs no host sync."""
    hits = torch.zeros(n + 1, dtype=torch.int32, device=slot_mask.device)
    hits.index_add_(0, safe_parent, slot_mask.to(torch.int32))
    return hits[:n] > 0


def compile_predicate(pred: Predicate):
    """The mask program for this predicate's tree shape.

    Signature of the returned fn::

        fn(row: RowView, struct: PathStruct, base: int, params: int32[K])
            -> (mask: bool[N], count: int32 0-d)

    ``mask`` is indexed by path id and true exactly for the direct children
    of ``base`` satisfying the predicate; both stay on the row's device.
    Cached per tree shape: probe values and fields are scalars of
    ``params``."""
    sig = pred.signature()
    fn = _COMPILED.get(sig)
    if fn is not None:
        return fn

    atom_list = list(pred.atoms())

    def program(row, struct, base, params):
        n = struct.parent.shape[0]
        safe_parent = torch.where(struct.parent >= 0, struct.parent, n).long()

        # one child-level boolean vector per atom, in pred.atoms() order
        idx = 0
        masks: List[torch.Tensor] = []
        for atom in atom_list:
            leaf_form = atom.field is None
            if leaf_form:
                structural = struct.parent == base
            else:
                fid = params[idx]
                idx += 1
                structural = (struct.parent2 == base) & (struct.seg == fid)
            if atom.kind == "eq":
                vid = params[idx]
                idx += 1
                slot = structural & (row.vid == vid) & (vid >= 0)
            elif atom.kind == "rng":
                lo_hi, lo_lo, hi_hi, hi_lo = params[idx:idx + 4]
                idx += 4
                ge_lo = (row.khi > lo_hi) | ((row.khi == lo_hi) & (row.klo >= lo_lo))
                le_hi = (row.khi < hi_hi) | ((row.khi == hi_hi) & (row.klo <= hi_lo))
                slot = structural & (row.cls == CLS_NUMBER) & ge_lo & le_hi
            else:  # "ex"
                slot = structural & (row.cls != CLS_ABSENT) & (row.vid != VID_NULL)
            # leaf form: the slot IS the child (indexed by pid)
            masks.append(slot if leaf_form else _child_level(slot, safe_parent, n))

        it = iter(masks)

        def combine(node):
            if isinstance(node, _And):
                return combine(node.a) & combine(node.b)
            if isinstance(node, _Or):
                return combine(node.a) | combine(node.b)
            if isinstance(node, _Not):
                return ~combine(node.a)
            return next(it)

        mask = combine(pred) & (struct.parent == base)
        return mask, mask.sum(dtype=torch.int32)

    _COMPILED[sig] = program
    return program


def predicate_params(pred: Predicate, seg_lookup, encode_value) -> "list[int]":
    """Flatten the predicate's probe values into the traced i32 params the
    compiled program expects — run BEFORE the device sync (``encode_value``
    may intern new probe values / trigger a string re-key)."""
    params: List[int] = []
    for atom in pred.atoms():
        if atom.field is not None:
            params.append(int(seg_lookup(atom.field)))
        if atom.kind == "eq":
            if atom.probe is None:
                params.append(-1)  # null probes match nothing
            else:
                params.append(int(encode_value(atom.probe)[3]))
        elif atom.kind == "rng":
            params.extend(atom.key_interval())
    return params
