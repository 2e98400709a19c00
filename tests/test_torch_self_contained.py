"""The port is self-contained: no file of bullet_tpu_torch/, nor
chip_smoke.py or a script in tools/, imports the JAX package or JAX, or
finds the JAX package's files through ``bullet_tpu.__file__``; and the
port's own copies of the framework-free modules (utils/encode, utils/paths,
parallel/topology, the native host runtime, the host db layer, whose code
must be the reference's, docstrings apart) give the reference's results
on the same seeded inputs, native against native also in a process that
lost the race to build the reference's library (tests/_native_libs.py).
The reference modules are imported here, by the test, never by the
port."""

import ast
import copy
import os
import re
from pathlib import Path

import numpy as np
import pytest

import random

from bullet_tpu import native as ref_native
from bullet_tpu.ops import predicates as ref_pred
from bullet_tpu.ops import rank as ref_rank
from bullet_tpu.parallel import topology as ref_topo
from bullet_tpu.utils import encode as ref_encode
from bullet_tpu.utils import paths as ref_paths
from bullet_tpu_torch import native as port_native
from bullet_tpu_torch.ops import predicates as port_pred
from bullet_tpu_torch.ops import rank as port_rank
from bullet_tpu_torch.parallel import topology as port_topo
from bullet_tpu_torch.utils import encode as port_encode
from bullet_tpu_torch.utils import paths as port_paths

from _native_libs import load_native

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("bullet_tpu", "jax", "jaxlib")
# the host db layer, copied whole: the port's files are the reference's
# code, docstrings apart
DB_MODULES = sorted(p.name for p in (REPO / "bullet_tpu" / "db").glob("*.py"))


def port_files():
    files = sorted((REPO / "bullet_tpu_torch").rglob("*.py"))
    # the multihost test's worker runs in processes that must not import JAX
    return files + [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py")),
                    REPO / "tests" / "_torch_multihost_worker.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def violations(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Attribute) and node.attr == "__file__":
            if isinstance(node.value, ast.Name) and _forbidden(node.value.id):
                found.append(f"{node.value.id}.__file__")
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _forbidden(arg.value)):
                found.append(f"{name}({arg.value!r})")
    return found


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 20
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"bullet_tpu_torch/ops/rank.py", "bullet_tpu_torch/ops/packed.py",
            "bullet_tpu_torch/models/netsim.py", "bullet_tpu_torch/convert.py",
            "bullet_tpu_torch/ops/scans.py", "bullet_tpu_torch/ops/predicates.py",
            "bullet_tpu_torch/__init__.py", "bullet_tpu_torch/__main__.py",
            "bullet_tpu_torch/models/ingress.py", "bullet_tpu_torch/models/bridge.py",
            "bullet_tpu_torch/models/checkpoint.py", "bullet_tpu_torch/utils/observe.py",
            "bullet_tpu_torch/parallel/multihost.py", "tests/_torch_multihost_worker.py"} <= names
    assert {f"bullet_tpu_torch/db/{m}" for m in DB_MODULES} <= names
    bad = {str(f.relative_to(REPO)): v for f in files if (v := violations(f))}
    assert not bad, bad


def test_bridge_and_serializer_make_the_ports_db_objects():
    """The sim's scratch Bullet (its serializer facade) and the Bullets a
    bridge reads and writes are the port's own, never the reference's."""
    import bullet_tpu_torch
    from bullet_tpu_torch import PeerNetworkSim
    from bullet_tpu_torch.models.bridge import dump_sim_into_bullet, sim_from_bullet

    sim = PeerNetworkSim(2, capacity=64, device="cpu")
    scratch = sim._scratch_bullet()
    db = bullet_tpu_torch.create({"storage": False, "disable_network": True})
    try:
        assert type(scratch).__module__ == type(db).__module__ == "bullet_tpu_torch.db.core"
        db.get("a").put({"b": 1})
        mirror = sim_from_bullet(db, 2, device="cpu")
        assert type(mirror).__module__ == "bullet_tpu_torch.models.netsim"
        assert dump_sim_into_bullet(mirror, scratch, peer=1) == 1
        assert scratch.store == db.store
    finally:
        scratch.close()
        db.close()


def test_the_scan_catches_each_form(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text(
        "import jax\nimport jax.numpy as jnp\nfrom bullet_tpu.utils import encode\n"
        "import bullet_tpu_torch\nfrom .x import y\nimport importlib\n"
        "p = bullet_tpu.__file__\nm = importlib.import_module('bullet_tpu.native')\n"
    )
    assert violations(src) == [
        "jax", "jax.numpy", "bullet_tpu.utils", "bullet_tpu.__file__",
        "import_module('bullet_tpu.native')",
    ]


def test_native_library_builds_outside_the_sources(monkeypatch):
    lib = load_native(port_native, monkeypatch)
    if lib is None:
        pytest.skip("no C++ toolchain: the numpy fallbacks run")
    target = port_native._lib_path()
    assert target.exists()
    assert (REPO / "build" / "bullet_tpu_torch" / "native") in target.parents
    assert not list((REPO / "bullet_tpu_torch" / "native").glob("*.so"))
    assert os.path.samefile(lib._name, target)


def _values(rng):
    nums = rng.normal(0, 1e6, 300).tolist() + [0.0, -0.0, 1e308, -1e-308, 3, 7, 7.5]
    strs = [f"s{int(i)}" for i in rng.integers(0, 80, 120)] + ["", "Z", "é", "a" * 40]
    return nums + strs + [True, False, None, [1, 2], [{"a": 1}], "s3", 3.0]


def test_encode_matches_reference():
    rng = np.random.default_rng(0)
    vals = _values(rng)
    ref, port = ref_encode.ValueInterner(), port_encode.ValueInterner()
    assert [port.encode(v) for v in vals] == [ref.encode(v) for v in vals]
    for a, b in zip(port.key_table(), ref.key_table()):
        np.testing.assert_array_equal(a, b)
    more = rng.normal(0, 100, 2000)
    for a, b in zip(port_encode.bulk_encode_numbers(port, more),
                    ref_encode.bulk_encode_numbers(ref, more)):
        np.testing.assert_array_equal(a, b)
    mixed = vals[::-1] + [f"new{i}" for i in range(50)]
    for a, b in zip(port_encode.bulk_encode_values(port, mixed),
                    ref_encode.bulk_encode_values(ref, mixed)):
        np.testing.assert_array_equal(a, b)
    vids = np.arange(len(ref))
    assert port.decode_batch(vids).tolist() == ref.decode_batch(vids).tolist()
    assert port.epoch == ref.epoch


def test_paths_match_reference(monkeypatch):
    load_native(ref_native, monkeypatch)
    load_native(port_native, monkeypatch)
    _assert_paths_match()


def test_native_parity_survives_a_lost_build_race(monkeypatch):
    """A process whose build of the reference's library lost the race to
    another's (the library exists, the failure flag is set, nothing is
    loaded, so the reference hands out its Python interner) still compares
    the two native path interners."""
    if any(load_native(lib, monkeypatch) is None for lib in (port_native, ref_native)):
        pytest.skip("no C++ toolchain: the numpy fallbacks run")
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_load_failed", True)
    assert ref_native.load() is None
    assert type(ref_native.make_path_interner()).__name__ == "PathInterner"
    assert load_native(ref_native, monkeypatch) is not None
    assert type(ref_native.make_path_interner()).__name__ == "NativePathInterner"
    _assert_paths_match()


def _assert_paths_match():
    """The port's path interners (Python, and native where it loads) give
    the reference's ids, paths, parents and lookups."""
    rng = np.random.default_rng(1)
    paths = [f"r{int(a)}/m{int(b)}/leaf{int(c)}" for a, b, c in rng.integers(0, 6, (400, 3))]
    for make_ref, make_port in (
        (ref_paths.PathInterner, port_paths.PathInterner),
        (ref_native.make_path_interner, port_native.make_path_interner),
    ):
        ref, port = make_ref(), make_port()
        assert type(ref).__name__ == type(port).__name__
        ids_ref = [ref.intern(p) for p in paths]
        assert [port.intern(p) for p in paths] == ids_ref
        assert len(port) == len(ref)
        for pid in range(len(ref)):
            assert port.path(pid) == ref.path(pid)
            assert port.parent(pid) == ref.parent(pid)
        assert [port.lookup(p) for p in paths[:50] + ["nope/x"]] == [
            ref.lookup(p) for p in paths[:50] + ["nope/x"]]


@pytest.mark.parametrize("build", [
    lambda t: t.ring(9), lambda t: t.chain(7), lambda t: t.full_mesh(5),
    lambda t: t.star(6, hub=2), lambda t: t.bridge((4, 3), 1),
    lambda t: t.random_graph(12, 3, seed=4),
    lambda t: t.from_adjacency(np.random.default_rng(2).random((10, 10)) < 0.2),
])
def test_topology_matches_reference(build):
    ref, port = build(ref_topo), build(port_topo)
    np.testing.assert_array_equal(port.neighbors, ref.neighbors)
    assert (port.name, port.kind, port.num_peers, port.diameter) == (
        ref.name, ref.kind, ref.num_peers, ref.diameter)
    np.testing.assert_array_equal(port.strong_components(), ref.strong_components())
    assert port.is_connected() == ref.is_connected()
    dropped_ref, dropped_port = ref.drop_peer(1), port.drop_peer(1)
    np.testing.assert_array_equal(dropped_port.neighbors, dropped_ref.neighbors)


def test_native_matches_reference(monkeypatch):
    if any(load_native(lib, monkeypatch) is None for lib in (port_native, ref_native)):
        pytest.skip("no C++ toolchain: the numpy fallbacks run")
    rng = np.random.default_rng(3)
    k = 5000
    raw = (rng.integers(0, 32, k), rng.integers(0, 300, k), rng.integers(0, 5, k),
           rng.integers(-99, 99, k), rng.integers(-99, 99, k), rng.integers(0, 1000, k))
    raw = tuple(a.astype(np.int32) for a in raw)
    for bn, nb in ((0, 0), (128, 4)):
        got = port_native.reduce_flat_ops(*raw, bn, nb, 28, (1 << 28) - 1)
        want = ref_native.reduce_flat_ops(*raw, bn, nb, 28, (1 << 28) - 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port_native.group_positions(raw[0], 32),
                    ref_native.group_positions(raw[0], 32)):
        np.testing.assert_array_equal(a, b)
    vals = rng.normal(0, 1e9, 1000)
    for a, b in zip(port_native.number_keys(vals), ref_native.number_keys(vals)):
        np.testing.assert_array_equal(a, b)


def _fuzz_tree(mod, rng, depth=3):
    """A random predicate from ``mod``'s DSL (``rng`` replays it)."""
    probes = [-5, 0, 0.5, 2, 1e300, -0.0, float("nan"), float("inf"), True, False, "x", "",
              None, [1, "a"], 7]

    def atom():
        f = rng.choice(["a", "b", None])
        fld = mod.P.value() if f is None else mod.P[f]
        r = rng.random()
        if r < 0.35:
            op = rng.choice(["__lt__", "__le__", "__gt__", "__ge__"])
            return getattr(fld, op)(rng.choice([x for x in probes if isinstance(x, (int, float))]))
        if r < 0.5:
            return fld.between(rng.choice([-3, 0, 1.5, float("nan")]), rng.choice([-1, 2, 9]))
        if r < 0.8:
            return fld == rng.choice(probes)
        if r < 0.9:
            return fld != rng.choice(probes)
        return mod.P.has(f or "b")

    def tree(d):
        if d == 0 or rng.random() < 0.3:
            return atom()
        r = rng.random()
        if r < 0.4:
            return tree(d - 1) & tree(d - 1)
        if r < 0.8:
            return tree(d - 1) | tree(d - 1)
        return ~tree(d - 1)

    return tree(depth)


@pytest.mark.parametrize("seed", range(4))
def test_predicate_host_half_matches_reference(seed):
    """The port's copy of the predicate AST gives the reference's
    signatures, ``evaluate`` results, key intervals and params."""
    values = [None, 3, -0.0, 2.5, float("nan"), True, "x", [1, "a"],
              {"a": 1, "b": "x"}, {"a": None}, {"a": {"deep": 1}, "b": True},
              {"a": float("inf"), "b": -5}, {"b": [1, "a"]}, {"a": 1e300}]
    for k in range(40):
        ref = _fuzz_tree(ref_pred, random.Random(1000 * seed + k))
        port = _fuzz_tree(port_pred, random.Random(1000 * seed + k))
        assert port.signature() == ref.signature()
        assert [port.evaluate(v) for v in values] == [ref.evaluate(v) for v in values]
        for pa, ra in zip(port.atoms(), ref.atoms()):
            if ra.kind == "rng":
                assert pa.key_interval() == ra.key_interval()
        ref_vals, port_vals = ref_encode.ValueInterner(), port_encode.ValueInterner()
        segs = {"a": 3, "b": -1}
        want = ref_pred.predicate_params(ref, segs.get, ref_vals.encode)
        assert port_pred.predicate_params(port, segs.get, port_vals.encode) == want
        assert [port_vals.encode(v) for v in ("x", 7)] == [ref_vals.encode(v) for v in ("x", 7)]


@pytest.mark.parametrize("seed", range(3))
def test_rank_bounds_match_reference(seed):
    """RankIndex.rank_bounds on the same inserts, over random key
    intervals of every class (bounds interned or not, empty and inverted
    intervals)."""
    rng = np.random.default_rng(seed)
    ref, port = ref_rank.RankIndex(), port_rank.RankIndex()
    n = 0
    for _ in range(3):
        k = int(rng.integers(5, 60))
        cls = rng.integers(1, 5, k)
        khi = rng.integers(-4, 4, k)
        klo = rng.integers(-4, 4, k)
        vids = np.arange(n, n + k)
        n += k
        for index in (ref, port):
            index.insert_batch(vids, cls, khi, klo)
    for _ in range(200):
        c = int(rng.integers(0, 6))
        lo = [int(x) for x in rng.integers(-5, 5, 2)]
        hi = [int(x) for x in rng.integers(-5, 5, 2)]
        assert port.rank_bounds(c, *lo, *hi) == ref.rank_bounds(c, *lo, *hi), (c, lo, hi)
    assert port_rank.RankIndex().rank_bounds(2, 0, 0, 1, 1) is None
    assert ref_rank.RankIndex().rank_bounds(2, 0, 0, 1, 1) is None


# ------------------------------------------------------------ the db copy


def _code_only(path: Path) -> str:
    """The module's AST without docstrings (module, class and function)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant) and isinstance(
                    body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", DB_MODULES)
def test_db_copy_is_the_reference_code(module):
    """Each copied db module is the reference's code: only docstrings
    (which name the package and bullet-js's sources) differ."""
    assert len(DB_MODULES) == 13
    port = REPO / "bullet_tpu_torch" / "db" / module
    assert _code_only(port) == _code_only(REPO / "bullet_tpu" / "db" / module)
    assert not violations(port)


class _Owner:
    """The few attributes the db components read from their Bullet."""

    def __init__(self):
        self.id = "node-a"
        self.log, self.meta, self.store = [], {}, {}


def _tree(rng, depth=3):
    if depth == 0 or rng.random() < 0.3:
        return [int(rng.integers(-3, 3)), "s" + str(int(rng.integers(3))), True, None,
                float(rng.integers(-8, 8)) / 4, [1, "a"]][int(rng.integers(6))]
    return {f"k{int(rng.integers(4))}": _tree(rng, depth - 1)
            for _ in range(int(rng.integers(1, 4)))}


def test_db_crt_matches_reference():
    from bullet_tpu.db import crt as ref
    from bullet_tpu_torch.db import crt as port

    rng = np.random.default_rng(11)

    def clock():
        if rng.random() < 0.1:
            return None
        return {n: int(rng.integers(0, 3)) for n in ("node-a", "b", "c") if rng.random() < 0.7}

    resolvers = (ref.BulletCRT(_Owner()), port.BulletCRT(_Owner()))
    for i in range(300):
        c1, c2, v1, v2 = clock(), clock(), _tree(rng, 2), _tree(rng, 2)
        assert port.compare_vector_clocks(c1, c2) == ref.compare_vector_clocks(c1, c2)
        if c1 is not None and c2 is not None:
            assert port.merge_vector_clocks(c1, c2) == ref.merge_vector_clocks(c1, c2)
        key = f"p{i % 7}"
        want, got = (r.resolve(key, dict(c1 or {}), c2 and dict(c2), v1, v2) for r in resolvers)
        assert vars(got) == vars(want), i
    assert resolvers[1].vector_clocks == resolvers[0].vector_clocks


def test_db_validation_matches_reference():
    from bullet_tpu.db import validation as ref
    from bullet_tpu_torch.db import validation as port

    schema = {"type": "object", "properties": {
        "name": {"type": "string", "required": True, "min": 2, "max": 6},
        "age": {"type": "integer", "min": 0, "max": 99},
        "kind": {"enum": ["a", "b", 1]},
        "email": {"type": "string", "format": "email"},
        "site": {"type": "string", "format": "url"},
        "tags": {"type": "array", "max": 2},
        "geo": {"type": "object", "properties": {"lat": {"type": "number", "min": -90}}},
    }}
    rng = np.random.default_rng(12)
    pool = ["ab", "abcdefg", "x", 5, 5.5, -1, 120, True, None, "a", 1, "a@b.co", "a@",
            "http://x.io", "nope", [1], [1, 2, 3], {"lat": -100}, {"lat": 3}]
    logs = ([], [])
    vals = []
    for log, mod in zip(logs, (ref, port)):
        v = mod.BulletValidation(None)
        v.define_schema("s", schema)
        v.apply_schema("users", "s")
        v.on_error("all", log.append)
        vals.append(v)
    for i in range(400):
        data = {f: pool[int(rng.integers(len(pool)))] for f in schema["properties"]
                if rng.random() < 0.6}
        path = ["users/u1", "users/u1/age", "users/u1/geo", "other/x"][int(rng.integers(4))]
        if path.count("/") == 2:
            data = data.get(path.rsplit("/", 1)[1], pool[int(rng.integers(len(pool)))])
        assert vals[1].check_write(path, data) == vals[0].check_write(path, data), (i, data)
    assert [(e.type, str(e), e.is_fatal) for e in logs[1]] == [
        (e.type, str(e), e.is_fatal) for e in logs[0]]
    assert len(logs[0]) > 50


def test_db_query_and_serializer_match_reference():
    import bullet_tpu
    import bullet_tpu_torch

    rng = np.random.default_rng(13)
    users = {f"u{i}": {"name": f"n{int(rng.integers(4))}", "age": int(rng.integers(0, 60)),
                       "ok": bool(rng.integers(2)), "deep": _tree(rng, 2)} for i in range(30)}
    out = []
    for bt in (bullet_tpu, bullet_tpu_torch):
        b = bt.create({"storage": False, "disable_network": True})
        try:
            for uid, data in users.items():
                b.get(f"users/{uid}").put(data)
            b.index("users", "name")
            got = [sorted(n.path for n in b.equals("users", "name", f"n{k}")) for k in range(5)]
            got += [sorted(n.path for n in b.range("users", "age", lo, lo + 15))
                    for lo in (0, 20, 50)]
            got.append(b.count("users", "ok", True))
            stamp = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?|\"timestamp\": ?\d+")
            exports = [stamp.sub("", getattr(b, f"export_to_{f}")("users"))
                       for f in ("json", "csv", "xml")]
            b2 = bt.create({"storage": False, "disable_network": True})
            try:
                b2.import_from_json(b.export_to_json("users"), "copy")
                b2.import_from_csv(b.export_to_csv("users"), "csv")
                got += [b2.get("copy").value(), b2.get("csv").value()]
            finally:
                b2.close()
            out.append((got, exports))
        finally:
            b.close()
    assert out[1] == out[0]


def test_db_middleware_matches_reference():
    import bullet_tpu
    import bullet_tpu_torch

    out = []
    for bt in (bullet_tpu, bullet_tpu_torch):
        b = bt.create({"storage": False, "disable_network": True})
        log = []
        try:
            b.middleware.rewrite_path(r"^old/(\w+)", "new/$1")
            b.middleware.transform("nums", lambda d: d * 3 if isinstance(d, int) else d, "write")
            b.middleware.access_control("locked", lambda op, path, data: op == "read")
            b.on("all", lambda event, data: log.append(event))
            r = np.random.default_rng(14)
            for i in range(60):
                base = ["old", "new", "nums", "locked", "free"][int(r.integers(5))]
                path = f"{base}/k{int(r.integers(4))}"
                if r.random() < 0.6:
                    b.get(path).put(int(r.integers(9)))
                else:
                    log.append(("read", path, b.get(path).value()))
            out.append((b.store, log))
        finally:
            b.close()
    assert out[1] == out[0]


def test_db_storage_matches_reference():
    from bullet_tpu.db import storage as ref
    from bullet_tpu_torch.db import storage as port

    rng = np.random.default_rng(15)
    for _ in range(100):
        a, c = _tree(rng), _tree(rng)
        if not isinstance(a, dict) or not isinstance(c, dict):
            continue
        got = [s._has_store_changes(a, c) for s in (ref.BulletStorage(_Owner()),
                                                    port.BulletStorage(_Owner()))]
        assert got[1] == got[0]
        merged = [s._deep_merge(copy.deepcopy(a), c) for s in (ref.BulletStorage(_Owner()),
                                                               port.BulletStorage(_Owner()))]
        assert merged[1] == merged[0]


def test_db_ws_framing_matches_reference():
    import io

    from bullet_tpu.db import ws as ref
    from bullet_tpu_torch.db import ws as port

    rng = np.random.default_rng(16)
    for n in [0, 1, 125, 126, 127, 65535, 65536, 70000]:
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for opcode in (port.OP_TEXT, 0x2, 0x9):
            frame = port.encode_frame(payload, opcode)
            assert frame == ref.encode_frame(payload, opcode)
            assert port.read_frame(io.BytesIO(frame)) == ref.read_frame(io.BytesIO(frame))
            masked = ref.encode_frame(payload, opcode, mask=True)
            assert port.read_frame(io.BytesIO(masked)) == (opcode, True, payload)
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    assert port.accept_key(key) == ref.accept_key(key) == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
