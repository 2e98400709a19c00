"""Engine batch-ingress pipeline: validation masks + middleware hooks.

The port of ``bullet_tpu.models.ingress``. The host db layer validates and
hooks every write individually (db/validation, db/middleware). The engine's
write path is a *batch* — ops enter as dense [P, B] tensors, or flat [K]
ones on the packed family — so the same two subsystems live here at the
batch boundary (SURVEY §7 stage 5):

* ``EngineValidation`` — named schemas (the host layer's normalization and
  constraint semantics, bullet-js src/bullet-validation.js:71-101, 259-323,
  333-463) bound to base paths. Scalar ``put`` gets the full host check
  with typed errors; bulk batches are vetoed **on the device**: applied
  schemas compile into rule tensors (base pid, field segment id, allowed
  cls range, encoded khi/klo bounds, enum vids) and a compare mask zeroes
  invalid ops (cls=0 = guaranteed-loser padding) before the apply ever
  sees them. Rejected ops are then re-validated on the host to produce
  exact typed errors (error handlers match bullet-validation.js:592-604).

* ``EngineHooks`` — the middleware twin (bullet-js
  src/bullet-middleware.js:27-135): put hooks veto/mutate puts before
  ingress, get/afterGet hooks wrap reads, afterPut hooks + the "write"
  event fire after the step applies the batch, and *traced transforms*
  (``use_traced_put``) run on the device over the whole encoded OpBatch —
  a put-middleware that touches every op at line rate.

The mask is plain PyTorch: the reference computes it with an XLA loop over
the rules, not a Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..db.validation import BulletValidation, ValidationError
from ..ops.apply import OpBatch
from ..ops.scans import PathStruct
from ..utils.encode import CLS_NULL, CLS_NUMBER, CLS_OPAQUE, number_key

_NEG_INF_KEY = number_key(float("-inf"))
_POS_INF_KEY = number_key(float("inf"))


class RuleTable(NamedTuple):
    """Compiled per-field constraint rules, one row per bound (base, field).

    All int32, on the sim's device. ``enum_vids`` is [R, E] padded with -1;
    a row with no enum has all -1 (enum check disabled). cls bounds express
    the type constraint (number → [2,2], string → [3,3], any → [0, 127]);
    khi/klo bounds the numeric min/max as encoded float64 order keys.
    """

    base: torch.Tensor  # [R] base path id (grandparent of the leaf slot)
    seg: torch.Tensor  # [R] field segment id
    cls_lo: torch.Tensor  # [R]
    cls_hi: torch.Tensor  # [R]
    khi_lo: torch.Tensor  # [R]
    klo_lo: torch.Tensor  # [R]
    khi_hi: torch.Tensor  # [R]
    klo_hi: torch.Tensor  # [R]
    enum_vids: torch.Tensor  # [R, E]


def _slot_index(slot: torch.Tensor, n: int) -> torch.Tensor:
    """Gather indices for ``slot``, wrapped and clamped into [0, n) as the
    reference's gathers do (a transform may write any slot)."""
    idx = slot.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)


def invalid_op_mask(ops: OpBatch, struct: PathStruct, rules: RuleTable) -> torch.Tensor:
    """Bool mask of ``ops``' shape ([P, B] dense or [K] flat): ops that
    violate a matching rule, in one pass over the R rules.

    Null puts (cls ≤ CLS_NULL) always pass — deletes are null puts and must
    work on schema-bound paths (same contract as the host ``check_write``).
    """
    idx = _slot_index(ops.slot, struct.parent2.shape[0])
    parent2 = struct.parent2[idx]
    seg = struct.seg[idx]
    checkable = ops.cls > CLS_NULL
    is_num = ops.cls == CLS_NUMBER
    invalid = torch.zeros_like(ops.cls, dtype=torch.bool)
    for r in range(rules.base.shape[0]):
        match = checkable & (parent2 == rules.base[r]) & (seg == rules.seg[r])
        bad_cls = (ops.cls < rules.cls_lo[r]) | (ops.cls > rules.cls_hi[r])
        below = (ops.khi < rules.khi_lo[r]) | (
            (ops.khi == rules.khi_lo[r]) & (ops.klo < rules.klo_lo[r])
        )
        above = (ops.khi > rules.khi_hi[r]) | (
            (ops.khi == rules.khi_hi[r]) & (ops.klo > rules.klo_hi[r])
        )
        bad_range = is_num & (below | above)
        evids = rules.enum_vids[r]
        enum_active = evids[0] >= 0
        enum_hit = (ops.vid[..., None] == evids).any(dim=-1)
        bad_enum = enum_active & ~enum_hit
        invalid |= match & (bad_cls | bad_range | bad_enum)
    return invalid


def veto_ops(ops: OpBatch, invalid: torch.Tensor) -> OpBatch:
    """Zero out invalid ops (cls=0 is the no-op padding convention)."""
    return ops._replace(cls=torch.where(invalid, 0, ops.cls))


class EngineValidation:
    """Schema registry + device rule compiler for a PeerNetworkSim."""

    _DEVICE_TYPES = {
        # type name -> inclusive cls range a valid value must fall in
        "number": (CLS_NUMBER, CLS_NUMBER),
        "integer": (CLS_NUMBER, CLS_NUMBER),
        "boolean": (CLS_NUMBER, CLS_NUMBER),  # refined by enum {true, false}
        "string": (CLS_NUMBER + 1, CLS_NUMBER + 1),
        "array": (CLS_OPAQUE, CLS_OPAQUE),
        "null": (CLS_NULL, CLS_NULL),
        "any": (0, 127),
        "object": (0, 127),  # leaf ops never carry objects; host-checked
    }

    def __init__(self, sim) -> None:
        self.sim = sim
        # standalone host validator: same schemas/normalization/typed errors
        self.host = BulletValidation(None)
        self._rules: Optional[RuleTable] = None
        self._rules_dirty = False

    # -------------------------------------------------------------- registry

    def define_schema(self, name: str, schema: dict) -> "EngineValidation":
        self.host.define_schema(name, schema)
        self._rules_dirty = True
        return self

    def apply_schema(self, base_path: str, schema_name: str) -> "EngineValidation":
        if self.sim is not None:
            self.sim._fast_put_ok = False  # scalar puts must validate now
        self.host.apply_schema(base_path, schema_name)
        self.sim.host.intern_path(base_path)
        self._rules_dirty = True
        return self

    def remove_schema(self, base_path: str) -> "EngineValidation":
        self.host.remove_schema(base_path)
        self._rules_dirty = True
        return self

    def on_error(self, error_type: str, handler) -> "EngineValidation":
        self.host.on_error(error_type, handler)
        return self

    def validate(self, schema_name: str, data: Any) -> bool:
        return self.host.validate(schema_name, data)

    @property
    def active(self) -> bool:
        return bool(self.host.path_schemas)

    # ----------------------------------------------------------- scalar path

    def check_put(self, path: str, value: Any) -> bool:
        """Full-fidelity host check for ``sim.put`` (typed errors fire)."""
        return self.host.check_write(path, value)

    # ----------------------------------------------------------- device path

    def rules(self) -> Optional[RuleTable]:
        """Compile (and cache) the applied schemas into device rule tensors.

        One rule per (bound base path, property) pair: member writes land at
        ``base/<member>/<prop>`` so the leaf's grandparent is the base pid and
        its segment the property name. Nested object properties are host
        territory (scalar put validates them; bulk is the flat numeric fast
        path by design).
        """
        if not self._rules_dirty and self._rules is not None:
            return self._rules
        Key = Tuple[int, int]
        rows: List[Tuple[int, int, Key, Key, Key, List[int]]] = []
        for base_path, schema_name in self.host.path_schemas.items():
            schema = self.host.schemas.get(schema_name)
            if not schema:
                continue
            base_pid = self.sim.host.intern_path(base_path)
            for prop, ps in schema["properties"].items():
                if "properties" in ps:  # nested object schema: host-checked
                    continue
                sid = self.sim.host._seg_id(prop)
                ptype = ps.get("type", "any")
                cls_rng = self._DEVICE_TYPES.get(ptype, (0, 127))
                lo_key, hi_key = _NEG_INF_KEY, _POS_INF_KEY
                if ptype in ("number", "integer"):
                    if isinstance(ps.get("min"), (int, float)):
                        lo_key = number_key(float(ps["min"]))
                    if isinstance(ps.get("max"), (int, float)):
                        hi_key = number_key(float(ps["max"]))
                enum_vids: List[int] = []
                if ptype == "boolean":
                    enum_vids = [
                        self.sim.host.encode_value(True)[3],
                        self.sim.host.encode_value(False)[3],
                    ]
                elif isinstance(ps.get("enum"), list) and ps["enum"]:
                    enum_vids = [
                        self.sim.host.encode_value(v)[3] for v in ps["enum"]
                    ]
                rows.append((base_pid, sid, cls_rng, lo_key, hi_key, enum_vids))
        if not rows:
            self._rules = None
            self._rules_dirty = False
            return None
        r = len(rows)
        e = max(1, max(len(row[5]) for row in rows))
        enum_arr = np.full((r, e), -1, dtype=np.int32)
        for i, row in enumerate(rows):
            enum_arr[i, : len(row[5])] = row[5]
        columns = [
            [row[0] for row in rows], [row[1] for row in rows],
            [row[2][0] for row in rows], [row[2][1] for row in rows],
            [row[3][0] for row in rows], [row[3][1] for row in rows],
            [row[4][0] for row in rows], [row[4][1] for row in rows],
        ]
        device = self.sim.device
        self._rules = RuleTable(
            *(torch.tensor(c, dtype=torch.int32, device=device) for c in columns),
            enum_vids=torch.from_numpy(enum_arr).to(device),
        )
        self._rules_dirty = False
        return self._rules

    def _strict_rules(self) -> List[Tuple[int, int, bool, bool, float, float]]:
        """Constraints the encoded-key device mask CANNOT express — integer
        integralness, boolean-vs-number identity (booleans encode as
        CLS_NUMBER, but JS typeof true is "boolean" so number/integer
        fields must reject them), and string/array length bounds — as
        (base_pid, seg_sid, need_int, no_bool, len_min, len_max) rows.
        These are enforced by a vectorized host mask at put_bulk ingress
        (the raw values are still in hand there); without it, bulk writes
        would silently under-enforce schemas that scalar puts reject."""
        rows = []
        for base_path, schema_name in self.host.path_schemas.items():
            schema = self.host.schemas.get(schema_name)
            if not schema:
                continue
            base_pid = self.sim.host.intern_path(base_path)
            for prop, ps in schema["properties"].items():
                if "properties" in ps:
                    continue
                ptype = ps.get("type", "any")
                need_int = ptype == "integer"
                no_bool = ptype in ("number", "integer")
                lmin = lmax = None
                if ptype in ("string", "array"):
                    if isinstance(ps.get("min"), (int, float)):
                        lmin = float(ps["min"])
                    if isinstance(ps.get("max"), (int, float)):
                        lmax = float(ps["max"])
                if need_int or no_bool or lmin is not None or lmax is not None:
                    rows.append(
                        (base_pid, self.sim.host._seg_id(prop), need_int,
                         no_bool,
                         -1.0 if lmin is None else lmin,
                         float("inf") if lmax is None else lmax)
                    )
        return rows

    def strict_bulk_mask(self, slots: np.ndarray, values) -> Optional[np.ndarray]:
        """[K] bool drop-mask for bulk ops violating strict constraints.
        ``values`` is the raw numeric array (fast path) or the raw value
        list (object path). Returns None when no strict rules are bound."""
        rules = self._strict_rules()
        if not rules:
            return None
        _parent, parent2, seg = self.sim.host.struct_np()
        p2 = parent2[slots]
        sg = seg[slots]
        k = len(slots)
        values_arr = values if isinstance(values, np.ndarray) else None
        is_bool = np.zeros(k, dtype=bool)
        if values_arr is not None and values_arr.dtype.kind in "ifu":
            v = values_arr.astype(np.float64, copy=False)
            bad_int = ~np.isfinite(v) | (v != np.floor(v))
            lengths = np.full(k, -1.0)  # numbers have no length constraint
        else:
            bad_int = np.empty(k, dtype=bool)
            lengths = np.full(k, -1.0)
            seq = values_arr if values_arr is not None else values
            for i, val in enumerate(seq):
                if isinstance(val, bool):
                    bad_int[i] = True
                    is_bool[i] = True
                elif isinstance(val, (int, float)):
                    bad_int[i] = not float(val).is_integer()
                else:
                    bad_int[i] = True  # type mask handles non-numbers anyway
                if isinstance(val, (str, list)):
                    lengths[i] = len(val)
        drop = np.zeros(k, dtype=bool)
        for base, sid, need_int, no_bool, lmin, lmax in rules:
            m = (p2 == base) & (sg == sid)
            if not m.any():
                continue
            if need_int:
                drop |= m & bad_int
            if no_bool:
                drop |= m & is_bool
            if lmin >= 0 or lmax != float("inf"):
                has_len = lengths >= 0
                drop |= m & has_len & ((lengths < lmin) | (lengths > lmax))
        return drop

    def report_rejections(self, ops: OpBatch, invalid: torch.Tensor) -> int:
        """Host-side typed errors for device-vetoed ops: re-validate each
        rejected (path, value) through the host checker so handlers get the
        exact error type/message the scalar path would have produced. Only
        the vetoed ops' slots and vids cross to the host, in row-major
        order (the reference's ``argwhere`` order)."""
        where = torch.nonzero(invalid)
        count = int(where.shape[0])
        if count == 0:
            return 0
        pos = tuple(where.t())
        slots = ops.slot[pos].cpu().numpy()
        vids = ops.vid[pos].cpu().numpy()
        for slot, vid in zip(slots.tolist(), vids.tolist()):
            path = self.sim.host.paths.path(slot)
            value = self.sim.host.values.decode(vid)
            ok = self.host.check_write(path, value)
            if ok:
                # device rule fired but host disagrees (shouldn't happen);
                # still surface it rather than silently dropping the op
                self.host._handle_error(
                    ValidationError(
                        "validation", f"Write to {path} vetoed by device rule", False
                    )
                )
        return count


class EngineHooks:
    """Batch-boundary middleware: host hooks + traced put transforms.

    Host hook contracts match the db layer (and the reference): a put hook
    may veto with ``False``, replace the data, or replace ``{"path","data"}``;
    get hooks may rewrite the path; afterGet hooks may rewrite the data; hook
    errors veto puts but only annotate reads (bullet-middleware.js:27-135).
    """

    def __init__(self, sim) -> None:
        self.sim = sim
        self._put: List[Callable] = []
        self._after_put: List[Callable] = []
        self._get: List[Callable] = []
        self._after_get: List[Callable] = []
        self._delete: List[Callable] = []
        self._after_delete: List[Callable] = []
        self._traced_put: List[Callable] = []
        self._events: Dict[str, List[Callable]] = {}
        # (peer, path, value) tuples for afterPut dispatch post-step
        self._pending_after: List[Tuple[int, str, Any]] = []

    @property
    def active(self) -> bool:
        return bool(
            self._put or self._after_put or self._get or self._after_get
            or self._delete or self._after_delete or self._traced_put
            or self._events
        )

    # ---------------------------------------------------------- registration

    def _disable_fast_put(self) -> None:
        # the sim's scalar fast path assumes no hooks and no validation;
        # any registration permanently routes puts through the full path
        # (conservative: un-registering never re-enables)
        if self.sim is not None:
            self.sim._fast_put_ok = False

    def use(self, operation: str, fn: Callable) -> "EngineHooks":
        self._disable_fast_put()
        table = {
            "put": self._put,
            "afterPut": self._after_put,
            "get": self._get,
            "afterGet": self._after_get,
            "delete": self._delete,
            "afterDelete": self._after_delete,
        }
        if operation not in table:
            raise ValueError(f"Unknown operation: {operation}")
        if not callable(fn):
            raise TypeError("Middleware must be a function")
        table[operation].append(fn)
        return self

    def use_traced_put(self, fn: Callable) -> "EngineHooks":
        """Register a PURE transform run on the device over every drained
        batch: called as ``fn(ops: OpBatch, struct: PathStruct) -> OpBatch``
        on the whole batch ([P, B] dense, [K] flat), tensors on the sim's
        device. This is how a put-middleware runs at device line rate
        (e.g. clamping, field-masking, tick-stamping) instead of per-op
        Python."""
        self._disable_fast_put()
        if not callable(fn):
            raise TypeError("Traced transform must be a function")
        self._traced_put.append(fn)
        return self

    def on_event(self, event: str, listener: Callable) -> "EngineHooks":
        self._disable_fast_put()
        self._events.setdefault(event, []).append(listener)
        return self

    # --------------------------------------------------------------- dispatch

    def emit(self, event: str, data: Any = None) -> None:
        for listener in list(self._events.get(event, ())):
            try:
                listener(data)
            except Exception:  # noqa: BLE001 - listener isolation
                pass
        for listener in list(self._events.get("all", ())):
            try:
                listener(event, data)
            except Exception:  # noqa: BLE001
                pass

    def run_put(self, peer: int, path: str, value: Any):
        """(cont, path, value) — same decision contract as the db layer."""
        for fn in self._put:
            try:
                result = _call_hook(fn, path, value, peer)
            except Exception as error:  # noqa: BLE001
                self.emit("error", {"operation": "put", "path": path, "error": error})
                return False, path, value
            if result is False:
                return False, path, value
            if result is not None:
                if isinstance(result, dict) and "path" in result and "data" in result:
                    path, value = result["path"], result["data"]
                else:
                    value = result
        return True, path, value

    def queue_after_put(self, peer: int, path: str, value: Any) -> None:
        if self._after_put or self._events:
            self._pending_after.append((peer, path, value))

    def fire_after_puts(self) -> None:
        """afterPut hooks + "write" events, once the step has applied the
        batch (the engine's write "lands" at the step boundary)."""
        pending, self._pending_after = self._pending_after, []
        for peer, path, value in pending:
            for fn in self._after_put:
                try:
                    _call_hook(fn, path, value, peer)
                except Exception as error:  # noqa: BLE001
                    self.emit(
                        "error",
                        {"operation": "afterPut", "path": path, "error": error},
                    )
            self.emit("write", {"peer": peer, "path": path, "data": value})

    def rewrite_get(self, peer: int, path: str) -> str:
        for fn in self._get:
            try:
                result = _call_hook(fn, path, None, peer)
                if isinstance(result, str):
                    path = result
            except Exception as error:  # noqa: BLE001
                self.emit("error", {"operation": "get", "path": path, "error": error})
        return path

    def rewrite_after_get(self, peer: int, path: str, data: Any) -> Any:
        for fn in self._after_get:
            try:
                result = _call_hook(fn, path, data, peer)
                if result is not None:
                    data = result
            except Exception as error:  # noqa: BLE001
                self.emit(
                    "error",
                    {"operation": "afterGet", "path": path, "error": error},
                )
        self.emit("read", {"peer": peer, "path": path, "data": data})
        return data

    def run_delete(self, peer: int, path: str) -> bool:
        """delete hooks may veto (return False); afterDelete fires after the
        null-put is queued (bullet-middleware.js:137-186 semantics)."""
        for fn in self._delete:
            try:
                if _call_hook(fn, path, None, peer) is False:
                    return False
            except Exception as error:  # noqa: BLE001
                self.emit(
                    "error", {"operation": "delete", "path": path, "error": error}
                )
                return False
        return True

    def fire_after_delete(self, peer: int, path: str) -> None:
        for fn in self._after_delete:
            try:
                _call_hook(fn, path, None, peer)
            except Exception as error:  # noqa: BLE001
                self.emit(
                    "error", {"operation": "afterDelete", "path": path, "error": error}
                )
        self.emit("delete", {"peer": peer, "path": path})


@functools.lru_cache(maxsize=64)
def traced_pipeline(transforms: Tuple[Callable, ...]):
    """One function composing the traced put transforms, built once per
    distinct transform tuple (each transform is a PyTorch program over the
    whole batch; nothing is compiled)."""

    def run(ops: OpBatch, struct: PathStruct) -> OpBatch:
        for fn in transforms:
            ops = fn(ops, struct)
        return ops

    return run


@functools.lru_cache(maxsize=512)
def _hook_arity(fn) -> int:
    """Positional params a hook accepts (capped at 3), decided by signature
    inspection — NOT by catching TypeError, which would misattribute errors
    raised inside the hook body."""
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (ValueError, TypeError):
        return 2
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return 3
    n = sum(
        1
        for p in params
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    )
    return min(n, 3)


def _call_hook(fn, path, value, peer):
    """Hooks accept (path, data) like the reference, or (path, data, peer)."""
    if _hook_arity(fn) >= 3:
        return fn(path, value, peer)
    return fn(path, value)
