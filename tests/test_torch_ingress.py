"""Batch ingress on the port's sims: schema validation with the device veto
mask, middleware put/get/delete hooks with events, and traced put
transforms, on every layout (dense, lean, packed, rank, rank1), on one
device and on the 8-way CPU mesh.

Three kinds of test:

* the cases of ``tests/test_engine_ingress.py`` and
  ``tests/test_fast_put.py::test_registration_disables_fast_path``, on the
  port's sims of every layout;
* ``invalid_op_mask``, ``veto_ops``, ``rules()`` and the traced pipeline
  against the JAX functions on the same seeded inputs;
* seeded op sequences into a reference sim and a port sim with the same
  schemas, hooks and traced transform (written in jnp for the one, in
  torch for the other): after every op the return values, ``stats``, the
  tables and the calls of every handler and hook must be equal.

Every comparison is exact (int32 tables)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.models import ingress as ref_ingress
from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops.apply import OpBatch as JaxOps
from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.db.validation import ValidationError
from bullet_tpu_torch.models import ingress
from bullet_tpu_torch.ops.apply import OpBatch
from bullet_tpu_torch.utils.encode import CLS_NUMBER, number_key

torch.set_num_threads(2)

LAYOUTS = {
    "dense": dict(layout="dense"),
    "lean": dict(layout="dense", lean_gossip=True),
    "packed": dict(layout="packed"),
    "rank": dict(layout="rank"),
    "rank1": dict(layout="rank1"),
}

USER_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "required": True},
        "age": {"type": "number", "min": 0, "max": 150},
        "role": {"type": "string", "enum": ["admin", "user", "guest"]},
        "active": {"type": "boolean"},
        "email": {"type": "string", "format": "email"},
    },
    "required": ["name"],
}


@pytest.fixture(params=list(LAYOUTS))
def kw(request):
    return LAYOUTS[request.param]


@pytest.fixture
def sim(kw):
    s = PeerNetworkSim(4, capacity=256, topology="ring", mode="reference", device="cpu", **kw)
    s.define_schema("user", USER_SCHEMA)
    s.apply_schema("users", "user")
    return s


@pytest.fixture
def make_sim(kw):
    return lambda: PeerNetworkSim(2, capacity=128, topology="ring", device="cpu", **kw)


# ------------------------------------------------------------- scalar put


def test_valid_put_passes(sim):
    assert sim.put(0, "users/u1", {"name": "alice", "age": 30, "role": "admin"})
    sim.run_until_converged()
    assert sim.get(2, "users/u1/name") == "alice"


def test_missing_required_blocked(sim):
    errors = []
    sim.on_validation_error("all", errors.append)
    assert not sim.put(0, "users/u2", {"age": 30})
    sim.run_until_converged()
    assert sim.get(0, "users/u2") is None
    assert errors and errors[0].type == "required"


def test_wrong_type_blocked_scalar(sim):
    errors = []
    sim.on_validation_error("type", errors.append)
    assert not sim.put(0, "users/u1/age", "not-a-number")
    assert errors and errors[0].type == "type"


def test_enum_blocked_scalar(sim):
    assert not sim.put(0, "users/u1/role", "superuser")
    assert sim.put(0, "users/u1/role", "guest")


def test_range_blocked_scalar(sim):
    assert not sim.put(0, "users/u1/age", 200)
    assert not sim.put(0, "users/u1/age", -1)
    assert sim.put(0, "users/u1/age", 42)


def test_email_format_scalar(sim):
    assert not sim.put(0, "users/u1/email", "nope")
    assert sim.put(0, "users/u1/email", "a@b.co")


def test_null_put_passes_on_schema_path(sim):
    """Deletes are null puts and must work on schema-bound paths."""
    sim.put(0, "users/u1", {"name": "alice", "age": 5})
    sim.run_until_converged()
    assert sim.put(0, "users/u1/age", None)


def test_explicit_validate_raises(sim):
    with pytest.raises(ValidationError):
        sim.validate("user", {"age": 1})
    assert sim.validate("user", {"name": "x"})


def test_unbound_paths_unaffected(sim):
    assert sim.put(0, "other/x", "anything at all")
    sim.run_until_converged()
    assert sim.get(1, "other/x") == "anything at all"


# ---------------------------------------------------------- device (bulk)


def test_bulk_range_vetoed_on_device(sim):
    """Invalid bulk rows are zeroed by the device mask before the apply."""
    errors = []
    sim.on_validation_error("all", errors.append)
    peers = np.array([0, 1, 2, 3], dtype=np.int32)
    paths = [f"users/u{i}/age" for i in range(4)]
    values = np.array([30.0, 200.0, -5.0, 64.0])  # 200 and -5 violate max/min
    sim.put_bulk(peers, paths, values)
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 2
    assert sim.get(0, "users/u0/age") == 30
    assert sim.get(0, "users/u1/age") is None
    assert sim.get(0, "users/u2/age") is None
    assert sim.get(0, "users/u3/age") == 64
    assert len(errors) == 2 and all(e.is_validation_error for e in errors)


def test_bulk_type_vetoed_on_device(sim):
    sim.put_bulk(
        np.array([0, 0], dtype=np.int32),
        ["users/u7/age", "users/u8/age"],
        [12, "twelve"],  # string into a number field
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(1, "users/u7/age") == 12
    assert sim.get(1, "users/u8/age") is None


def test_bulk_enum_vetoed_on_device(sim):
    sim.put_bulk(
        np.array([0, 0], dtype=np.int32),
        ["users/u7/role", "users/u8/role"],
        ["admin", "superuser"],
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(2, "users/u7/role") == "admin"
    assert sim.get(2, "users/u8/role") is None


def test_bulk_boolean_type_on_device(sim):
    sim.put_bulk(
        np.array([0, 0], dtype=np.int32),
        ["users/u7/active", "users/u8/active"],
        # object dtype: a plain [True, 3.5] list would be numpy-coerced
        np.array([True, 3.5], dtype=object),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(0, "users/u7/active") is True
    assert sim.get(0, "users/u8/active") is None


def test_bulk_unbound_paths_pass(sim):
    sim.put_bulk(
        np.array([0, 1], dtype=np.int32),
        ["metrics/m0", "metrics/m1"],
        np.array([1.5, -2.5]),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 0
    assert sim.get(3, "metrics/m1") == -2.5


def test_bulk_convergence_after_veto(sim):
    """Vetoed ops must not poison convergence: replicas stay bit-identical."""
    rng = np.random.default_rng(7)
    k = 64
    peers = rng.integers(0, 4, size=k).astype(np.int32)
    paths = [f"users/u{i % 8}/age" for i in range(k)]
    values = rng.uniform(-50, 250, size=k)  # ~half out of [0, 150]
    sim.put_bulk(peers, paths, values)
    sim.run_until_converged()
    assert sim.tables_equal()
    ages = [sim.get(0, f"users/u{i}/age") for i in range(8)]
    assert all(a is None or 0 <= a <= 150 for a in ages)


def test_remove_schema_lifts_rules(sim):
    sim.remove_schema("users")
    sim.put_bulk(np.array([0], dtype=np.int32), ["users/u1/age"], np.array([999.0]))
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 0
    assert sim.get(0, "users/u1/age") == 999


def test_bulk_integer_integralness_enforced(sim):
    """'integer' fields reject fractional bulk values (the host pre-mask at
    put_bulk ingress; the encoded-key device mask can't see integralness)."""
    errors = []
    sim.on_validation_error("all", errors.append)
    sim.define_schema("counted", {"properties": {"n": {"type": "integer"}}})
    sim.apply_schema("counts", "counted")
    sim.put_bulk(
        np.array([0, 1, 2], dtype=np.int32),
        ["counts/a/n", "counts/b/n", "counts/c/n"],
        np.array([3.0, 2.5, float("nan")]),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 2
    assert sim.get(3, "counts/a/n") == 3.0
    assert sim.get(3, "counts/b/n") is None
    assert sim.get(3, "counts/c/n") is None
    assert len(errors) == 2


def test_bulk_string_length_enforced(sim):
    sim.define_schema(
        "tagged", {"properties": {"tag": {"type": "string", "min": 3, "max": 5}}}
    )
    sim.apply_schema("tags", "tagged")
    sim.put_bulk(
        np.array([0, 0, 0], dtype=np.int32),
        ["tags/a/tag", "tags/b/tag", "tags/c/tag"],
        np.array(["ok!", "x", "waytoolong"], dtype=object),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 2
    assert sim.get(1, "tags/a/tag") == "ok!"
    assert sim.get(1, "tags/b/tag") is None
    assert sim.get(1, "tags/c/tag") is None


def test_bulk_scalar_parity_for_integer(sim):
    """Scalar and bulk writes agree on the same schema."""
    sim.define_schema("counted", {"properties": {"n": {"type": "integer"}}})
    sim.apply_schema("counts", "counted")
    assert not sim.put(0, "counts/z/n", 1.5)  # scalar: host check rejects
    sim.put_bulk(np.array([0], dtype=np.int32), ["counts/z/n"], np.array([1.5]))
    sim.run_until_converged()
    assert sim.get(0, "counts/z/n") is None


# ---------------------------------------------------------------- hooks


def test_before_put_veto(make_sim):
    s = make_sim()
    s.use("put", lambda path, data: False if path.startswith("secret") else None)
    assert not s.put(0, "secret/x", 1)
    assert s.put(0, "open/x", 1)
    s.run_until_converged()
    assert s.get(0, "secret/x") is None
    assert s.get(0, "open/x") == 1


def test_before_put_mutate_data(make_sim):
    s = make_sim()
    s.use("put", lambda path, data: data * 2 if isinstance(data, (int, float)) else None)
    s.put(0, "n", 21)
    s.run_until_converged()
    assert s.get(1, "n") == 42


def test_before_put_redirect_path(make_sim):
    s = make_sim()
    s.use("put", lambda path, data: {"path": "real/" + path, "data": data})
    s.put(0, "x", 5)
    s.run_until_converged()
    assert s.get(0, "real/x") == 5
    assert s.get(0, "x") is None


def test_put_hook_error_blocks_write(make_sim):
    s = make_sim()
    errors = []
    s.on_event("error", errors.append)

    def bad_hook(path, data):
        raise RuntimeError("boom")

    s.use("put", bad_hook)
    assert not s.put(0, "x", 1)
    assert errors and errors[0]["operation"] == "put"


def test_after_put_fires_after_step(make_sim):
    s = make_sim()
    seen = []
    s.use("afterPut", lambda path, data, peer: seen.append((peer, path, data)))
    s.put(1, "a/b", 9)
    assert seen == []  # not yet applied
    s.step()
    assert seen == [(1, "a/b", 9)]


def test_get_hook_rewrites_path(make_sim):
    s = make_sim()
    s.put(0, "v2/conf", "new")
    s.run_until_converged()
    s.use("get", lambda path, data: path.replace("v1/", "v2/"))
    assert s.get(0, "v1/conf") == "new"


def test_after_get_transforms_data(make_sim):
    s = make_sim()
    s.put(0, "greet", "hello")
    s.run_until_converged()
    s.use("afterGet", lambda path, data: data.upper() if isinstance(data, str) else data)
    assert s.get(0, "greet") == "HELLO"


def test_get_hook_error_does_not_block_read(make_sim):
    s = make_sim()
    s.put(0, "k", 7)
    s.run_until_converged()

    def bad(path, data):
        raise RuntimeError("boom")

    s.use("get", bad)
    assert s.get(0, "k") == 7


def test_events_write_read_all(make_sim):
    s = make_sim()
    events = []
    s.on_event("write", lambda d: events.append(("write", d["path"])))
    s.on_event("read", lambda d: events.append(("read", d["path"])))
    s.on_event("all", lambda name, d: events.append(("all", name)))
    s.put(0, "e/x", 1)
    s.step()
    s.get(0, "e/x")
    names = [e[0] for e in events]
    assert "write" in names and "read" in names and "all" in names


def test_delete_hooks(make_sim):
    s = make_sim()
    s.put(0, "doomed", 1)
    s.put(0, "kept", 1)
    s.run_until_converged()
    deleted = []
    s.use("delete", lambda path, data: False if path == "kept" else None)
    s.use("afterDelete", lambda path, data: deleted.append(path))
    assert not s.remove(0, "kept")
    assert s.remove(0, "doomed")
    assert deleted == ["doomed"]


def test_peer_aware_hook_signature(make_sim):
    s = make_sim()
    seen = []
    s.use("put", lambda path, data, peer: seen.append(peer))
    s.put(1, "x", 1)
    assert seen == [1]


def test_use_unknown_operation_raises(make_sim):
    s = make_sim()
    with pytest.raises(ValueError):
        s.use("nope", lambda p, d: None)


def test_registration_disables_fast_path(kw):
    sim = PeerNetworkSim(4, capacity=256, topology="ring", device="cpu", **kw)
    assert sim._fast_put_ok
    sim.on_event("write", lambda *a: None)
    assert not sim._fast_put_ok
    sim2 = PeerNetworkSim(4, capacity=256, topology="ring", device="cpu", **kw)
    sim2.define_schema("s", {"properties": {"name": {"type": "string"}}})
    sim2.apply_schema("users", "s")
    assert not sim2._fast_put_ok
    # schema actually enforces on scalar puts after binding
    assert sim2.put(0, "users/u1/name", "ok")
    assert not sim2.put(0, "users/u1/name", 42)


# ---------------------------------------------------------- traced put


def _clamp_torch(cap, cap_vid):
    """A traced transform in torch: every number above ``cap`` becomes
    ``cap`` (its encoded key and vid)."""
    cap_hi, cap_lo = number_key(float(cap))

    def clamp(ops, struct):
        too_big = (ops.cls == CLS_NUMBER) & (
            (ops.khi > cap_hi) | ((ops.khi == cap_hi) & (ops.klo > cap_lo))
        )
        return ops._replace(
            khi=torch.where(too_big, cap_hi, ops.khi),
            klo=torch.where(too_big, cap_lo, ops.klo),
            vid=torch.where(too_big, cap_vid, ops.vid),
        )

    return clamp


def _clamp_jnp(cap, cap_vid):
    """The same transform in jnp, for the reference's sims."""
    cap_hi, cap_lo = number_key(float(cap))

    def clamp(ops, struct):
        too_big = (ops.cls == CLS_NUMBER) & (
            (ops.khi > cap_hi) | ((ops.khi == cap_hi) & (ops.klo > cap_lo))
        )
        return ops._replace(
            khi=jnp.where(too_big, cap_hi, ops.khi),
            klo=jnp.where(too_big, cap_lo, ops.klo),
            vid=jnp.where(too_big, cap_vid, ops.vid),
        )

    return clamp


def test_traced_put_transform_runs_in_step(make_sim):
    """A pure OpBatch transform runs on the whole batch at the apply: clamp
    every numeric op's encoded key to <= 100."""
    s = make_sim()
    s.use_traced_put(_clamp_torch(100, s.host.encode_value(100.0)[3]))
    s.put(0, "m/a", 50)
    s.put(0, "m/b", 12345)
    s.run_until_converged()
    assert s.get(1, "m/a") == 50
    assert s.get(1, "m/b") == 100


# ------------------------------------------------- the device functions


def _schema_sims():
    """A reference sim and a port sim with the same paths, values and
    schemas bound (number bounds, integer, boolean, enum, string, nested
    object, any)."""
    schemas = {
        "user": USER_SCHEMA,
        "item": {"properties": {
            "price": {"type": "number", "min": -2.5},
            "qty": {"type": "integer", "max": 1e6},
            "tags": {"type": "array", "min": 1},
            "meta": {"type": "object", "properties": {"x": {"type": "number"}}},
            "note": {},
            "kind": {"type": "string", "enum": ["a", "b", 3]},
        }},
    }
    sims = (JaxSim(4, capacity=256), PeerNetworkSim(4, capacity=256, device="cpu"))
    for s in sims:
        for name, schema in schemas.items():
            s.define_schema(name, schema)
        s.apply_schema("users", "user")
        s.apply_schema("items", "item")
        for base in ("users", "items", "other"):
            for m in range(5):
                for f in ("name", "age", "role", "active", "email", "price", "qty", "tags",
                          "kind", "note", "zz"):
                    s.intern_path(f"{base}/m{m}/{f}")
        for v in ("admin", "user", "x", "a", "b", 3, True, False, None, [1], 7.5, -3):
            s.host.encode_value(v)
    return sims


def test_rules_match_reference():
    ref, port = _schema_sims()
    want, got = ref.validation.rules(), port.validation.rules()
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.validation.rules() is got  # cached until the schemas change
    assert port.validation._strict_rules() == ref.validation._strict_rules()


def _random_ops(rng, shape, sim, rules):
    """Seeded ops on the bound paths and others: classes of every kind,
    number keys on and around each rule's bounds, enum vids and others."""
    k = int(np.prod(shape))
    keys = [number_key(x) for x in (-1e9, -2.5, -2.4, -1, 0, 13, 150, 150.5, 1e6, 1e7)]
    khi_lo, klo_lo = np.asarray(rules.khi_lo), np.asarray(rules.klo_lo)
    khi_hi, klo_hi = np.asarray(rules.khi_hi), np.asarray(rules.klo_hi)
    keys += list(zip(khi_lo.tolist(), klo_lo.tolist()))
    keys += list(zip(khi_hi.tolist(), klo_hi.tolist()))
    pick = rng.integers(0, len(keys), k)
    khi = np.asarray([keys[i][0] for i in pick], dtype=np.int32)
    klo = np.asarray([keys[i][1] for i in pick], dtype=np.int32)
    klo = (klo + rng.integers(-1, 2, k)).astype(np.int32)
    evids = np.asarray(rules.enum_vids).ravel()
    vid = np.where(rng.random(k) < 0.5, rng.choice(evids[evids >= 0], k),
                   rng.integers(0, len(sim.host.values), k)).astype(np.int32)
    fields = dict(
        slot=rng.integers(0, len(sim.host.paths), k).astype(np.int32),
        cls=rng.integers(0, 6, k).astype(np.int32),
        khi=khi, klo=klo, vid=vid,
        ctr=rng.integers(0, 9, k).astype(np.int32),
    )
    return {f: a.reshape(shape) for f, a in fields.items()}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", [(4, 64), (300,)], ids=["dense", "flat"])
def test_invalid_op_mask_and_veto_match_reference(shape, seed):
    ref, port = _schema_sims()
    rules_ref, rules = ref.validation.rules(), port.validation.rules()
    raw = _random_ops(np.random.default_rng(seed), shape, ref, rules_ref)
    ops_ref = JaxOps(**{f: jnp.asarray(a) for f, a in raw.items()})
    ops = OpBatch(**{f: torch.from_numpy(a) for f, a in raw.items()})
    want = np.asarray(ref_ingress.invalid_op_mask(ops_ref, ref.host.struct(), rules_ref))
    got = ingress.invalid_op_mask(ops, port.host.struct("cpu"), rules)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)
    vetoed_ref = ref_ingress.veto_ops(ops_ref, jnp.asarray(want))
    vetoed = ingress.veto_ops(ops, got)
    for a, b in zip(vetoed, vetoed_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    errors_ref, errors = [], []
    ref.on_validation_error("all", errors_ref.append)
    port.on_validation_error("all", errors.append)
    assert port.validation.report_rejections(ops, got) == \
        ref.validation.report_rejections(ops_ref, want) == want.sum()
    assert _errors(errors) == _errors(errors_ref)


def test_traced_pipeline_composes_in_order():
    ref, port = _schema_sims()
    raw = _random_ops(np.random.default_rng(5), (64,), ref, ref.validation.rules())
    port.validation.rules()  # interns the enum values, as the reference's did
    vid = ref.host.encode_value(10.0)[3]
    assert port.host.encode_value(10.0)[3] == vid
    shift = lambda o, s: o._replace(slot=o.slot + 1)  # noqa: E731
    got = ingress.traced_pipeline((_clamp_torch(10, vid), shift))(
        OpBatch(**{f: torch.from_numpy(a) for f, a in raw.items()}), port.host.struct("cpu"))
    want = ref_ingress.traced_pipeline((_clamp_jnp(10, vid), shift))(
        JaxOps(**{f: jnp.asarray(a) for f, a in raw.items()}), ref.host.struct())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ingress.traced_pipeline((shift,)) is ingress.traced_pipeline((shift,))


# ------------------------------------------- port sims against the reference


def _errors(log):
    return [(type(e).__name__, e.type, str(e), e.is_fatal) for e in log]


class Recorder:
    """Schemas, hooks, listeners and a traced transform registered on one
    sim, with a log of every call they receive."""

    def __init__(self, sim, traced):
        self.log = []
        self.errors = []
        sim.define_schema("user", USER_SCHEMA)
        sim.apply_schema("users", "user")
        sim.define_schema("counted", {"properties": {
            "n": {"type": "integer", "min": -5}, "tag": {"type": "string", "max": 3}}})
        sim.apply_schema("counts", "counted")
        sim.on_validation_error("all", self.errors.append)
        sim.use("put", self.put_hook)
        sim.use("afterPut",
                lambda path, data, peer: self.log.append(("afterPut", peer, path, data)))
        sim.use("get", lambda path, data: "users/" + path[5:] if path.startswith("view/") else None)
        sim.use("afterGet", self.after_get)
        sim.use("delete", lambda path, data: False if path.startswith("keep") else None)
        sim.use("afterDelete", lambda path, data: self.log.append(("afterDelete", path)))
        sim.on_event("write", lambda d: self.log.append(("write", d["peer"], d["path"], d["data"])))
        sim.on_event("error", lambda d: self.log.append(("error", d["operation"], d["path"])))
        cap_vid = sim.host.encode_value(1000.0)[3]
        sim.use_traced_put(traced(1000, cap_vid))

    def put_hook(self, path, data, peer):
        self.log.append(("put", peer, path, data))
        if path.startswith("secret"):
            return False
        if path.startswith("alias/"):
            return {"path": "real/" + path[6:], "data": data}
        if path.startswith("boom"):
            raise RuntimeError("boom")
        return None

    def after_get(self, path, data):
        self.log.append(("afterGet", path))
        if isinstance(data, (int, float)) and not isinstance(data, bool):
            return data + 1
        return None


def _value(rng):
    kind = int(rng.integers(7))
    if kind < 3:
        return [float(rng.integers(-20, 200)), int(rng.integers(-9, 2000)), 2.5][kind]
    if kind == 3:
        return ["admin", "guest", "superuser", "ab", "abcd", "x@y.io"][int(rng.integers(6))]
    if kind == 4:
        return bool(rng.integers(2))
    if kind == 5:
        return None
    return {"name": "n" + str(int(rng.integers(3))), "age": int(rng.integers(-5, 200))}


_FIELDS = ("name", "age", "role", "active", "email")


def _path(rng):
    r = rng.random()
    m = int(rng.integers(6))
    if r < 0.55:
        return f"users/u{m}/{_FIELDS[int(rng.integers(len(_FIELDS)))]}"
    if r < 0.65:
        return f"users/u{m}"
    if r < 0.75:
        return f"counts/c{m}/" + ("n" if rng.random() < 0.6 else "tag")
    return ["secret/s", "alias/a", "boom/b", "open/o", "keep/k"][int(rng.integers(5))] + str(m)


def _random_op(rng, p, i):
    r = rng.random()
    if i == 0 or r < 0.35:
        return "put", (int(rng.integers(p)), _path(rng), _value(rng))
    if r < 0.55:
        k = int(rng.integers(4, 40))
        peers = rng.integers(0, p, k)
        paths = [_path(rng) for _ in range(k)]
        if rng.random() < 0.5:
            return "put_bulk", (peers, paths, rng.integers(-30, 1500, k).astype(float) / 2)
        vals = [_value(rng) for _ in range(k)]
        return "put_bulk", (peers, paths, [v if not isinstance(v, dict) else 7 for v in vals])
    if r < 0.6:
        return "remove", (int(rng.integers(p)), _path(rng))
    if r < 0.7:
        return "step", (int(rng.integers(0, 3)),)
    if r < 0.75:
        return "fast_forward", (int(rng.integers(1, p + 2)),)
    if r < 0.82:
        return "run_until_converged", ()
    if r < 0.86:
        return "reconcile", ()
    if r < 0.94:
        return "get", (int(rng.integers(p)), _path(rng).replace("users/", "view/", 1))
    k = int(rng.integers(1, 12))
    return "get_bulk", (rng.integers(0, p, k), [_path(rng) for _ in range(k)])


def assert_same(js, ps, jr, pr, what):
    got = table_to_numpy(ps.table)
    assert len(got) == len(js.table), what
    for a, b in zip(got, js.table):
        np.testing.assert_array_equal(a, np.asarray(b), what)
    assert ps.stats == js.stats, what
    assert pr.log == jr.log, what
    assert _errors(pr.errors) == _errors(jr.errors), what


def fuzz(make, p, seed, n_ops):
    """``n_ops`` seeded ops into a reference sim and a port sim from
    ``make()``, each with a Recorder; after every op the results, stats,
    tables and logs agree."""
    rng = np.random.default_rng(seed)
    js, ps = make()
    jr, pr = Recorder(js, _clamp_jnp), Recorder(ps, _clamp_torch)
    for i in range(n_ops):
        name, args = _random_op(rng, p, i)
        want = getattr(js, name)(*args)
        got = getattr(ps, name)(*args)
        what = f"seed {seed} op {i}: {name}{args if name != 'put_bulk' else ''}"
        assert got == want, what
        assert_same(js, ps, jr, pr, what)
    assert ps.run_until_converged() == js.run_until_converged()
    assert_same(js, ps, jr, pr, f"seed {seed}: the last converge")
    assert ps.stats["ops_rejected"] > 0 and pr.errors and pr.log


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sequences_match_reference(name, seed):
    p = 8

    def make():
        kw = dict(capacity=128, **LAYOUTS[name])
        return JaxSim(p, **kw), PeerNetworkSim(p, device="cpu", **kw)

    fuzz(make, p, seed, 30)


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("winner_first", [True, False])
def test_veto_before_reduction(name, winner_first):
    """Two bulk ops on one (peer, slot): 20 (valid) and 500 (vetoed by
    max 150, and the lattice winner). The veto runs before the packed
    family's host reduction, so 20 lands, as in the reference."""
    values = np.array([500.0, 20.0] if winner_first else [20.0, 500.0])
    out = []
    for s in (JaxSim(4, capacity=64, **LAYOUTS[name]),
              PeerNetworkSim(4, capacity=64, device="cpu", **LAYOUTS[name])):
        errors = []
        s.define_schema("user", USER_SCHEMA)
        s.apply_schema("users", "user")
        s.on_validation_error("all", errors.append)
        s.put_bulk(np.array([1, 1], dtype=np.int32), ["users/a/age"] * 2, values)
        s.step(0)
        out.append((s.get(1, "users/a/age"), s.get(0, "users/a/age"), dict(s.stats),
                    _errors(errors)))
        s.run_until_converged()
        out.append((s.get(0, "users/a/age"), s.tables_equal()))
    assert out[2:] == out[:2]
    assert out[0][0] == 20 and out[0][2]["ops_rejected"] == 1 and out[0][2]["ops_applied"] == 1


# ------------------------------------------------------------ the mesh


@pytest.mark.parametrize("shard_map", [False, True], ids=["data", "shard_map"])
@pytest.mark.parametrize("layout", ["dense", "packed", "rank1"])
def test_validation_on_sharded_mesh(layout, shard_map):
    """The device veto composes with the sharded peer axis (8 virtual
    shards): ingress runs on the whole batch before the split by shard."""
    out = []
    for cls, extra in ((JaxSim, {}), (PeerNetworkSim, {"device": "cpu"})):
        s = cls(8, capacity=128, topology="ring", mesh_devices=8, layout=layout,
                use_shard_map=shard_map, **extra)
        errors = []
        s.define_schema("user", USER_SCHEMA)
        s.apply_schema("users", "user")
        s.on_validation_error("all", errors.append)
        peers = np.arange(8, dtype=np.int32)
        paths = [f"users/u{i}/age" for i in range(8)]
        values = np.where(np.arange(8) % 2 == 0, 30.0, 999.0)
        s.put_bulk(peers, paths, values)
        s.put_bulk(peers[::-1].copy(), paths, values[::-1].copy())
        s.run_until_converged()
        assert s.stats["ops_rejected"] == 8
        assert s.tables_equal()
        assert s.get(0, "users/u0/age") == 30
        assert s.get(0, "users/u1/age") == 30
        out.append((table_to_numpy(s.table) if cls is PeerNetworkSim
                    else [np.asarray(f) for f in s.table], dict(s.stats), _errors(errors)))
    for a, b in zip(out[1][0], out[0][0]):
        np.testing.assert_array_equal(a, b)
    assert out[1][1:] == out[0][1:]


@pytest.mark.parametrize("layout", ["dense", "rank1"])
def test_sequences_on_mesh_match_reference(layout):
    p = 16

    def make():
        kw = dict(capacity=128, mesh_devices=8, use_shard_map=True, layout=layout)
        return JaxSim(p, **kw), PeerNetworkSim(p, device="cpu", **kw)

    fuzz(make, p, 7, 24)


def test_fused_routes_with_schemas(monkeypatch):
    """One cell of test_torch_fused_routes.py with schemas, hooks and the
    traced transform bound: the card's fused routes forced on a CPU packed
    sim against the reference's ``use_pallas=True`` sim."""
    monkeypatch.setattr(PeerNetworkSim, "_card_routes", lambda self: True)
    p = 24

    def make():
        kw = dict(capacity=128, topology="ring", layout="packed")
        return (JaxSim(p, use_pallas=True, **kw),
                PeerNetworkSim(p, device="cpu", use_kernels=True, **kw))

    fuzz(make, p, 3, 24)
