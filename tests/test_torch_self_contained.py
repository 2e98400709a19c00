"""The port is self-contained: no file of bullet_tpu_torch/, nor
chip_smoke.py or a script in tools/, imports the JAX package or JAX, or
finds the JAX package's files through ``bullet_tpu.__file__``; and the
port's own copies of the framework-free modules (utils/encode, utils/paths,
parallel/topology, the native host runtime) give the reference's results
on the same seeded inputs, native against native also in a process that
lost the race to build the reference's library (tests/_native_libs.py).
The reference modules are imported here, by the test, never by the
port."""

import ast
import os
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


def port_files():
    files = sorted((REPO / "bullet_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py"))]


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
            "bullet_tpu_torch/ops/scans.py", "bullet_tpu_torch/ops/predicates.py"} <= names
    bad = {str(f.relative_to(REPO)): v for f in files if (v := violations(f))}
    assert not bad, bad


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
