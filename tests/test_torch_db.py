"""The port's host db layer (``bullet_tpu_torch.db``, a copy of
``bullet_tpu.db``) and its package entry.

* The deterministic db tests of the reference package
  (``test_core_db.py``, ``test_query.py``, ``test_validation.py``,
  ``test_serializer.py``, ``test_middleware.py``, ``test_storage.py``) run
  here on ``bullet_tpu_torch.create()``: each file's source is compiled
  with ``bullet_tpu`` renamed to ``bullet_tpu_torch``, and its tests and
  fixtures join this module under their own names. ``bullet_factory`` is
  this module's own, so it makes the port's Bullets. The TCP timing tests
  are not mirrored.
* A seeded fuzz runs one sequence of put/get/query/validate/export calls
  on ``bullet_tpu.create()`` and ``bullet_tpu_torch.create()`` and
  compares stores, query results, typed errors and serializer output.
* ``python -m bullet_tpu_torch --help``.
"""

import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import bullet_tpu
import bullet_tpu_torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
MIRRORED = ("test_core_db", "test_query", "test_validation", "test_serializer",
            "test_middleware", "test_storage")


def _mirror(name: str) -> types.ModuleType:
    """The reference's test module ``name``, compiled against the port."""
    path = TESTS / f"{name}.py"
    source = re.sub(r"\bbullet_tpu\b", "bullet_tpu_torch", path.read_text())
    module = types.ModuleType(f"torch_mirror_{name}")
    module.__file__ = str(path)
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


def _collect():
    taken = {}
    for name in MIRRORED:
        module = _mirror(name)
        for key, obj in vars(module).items():
            is_fixture = hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ in (
                "FixtureFunctionDefinition",)
            if key.startswith("test_") and callable(obj) or is_fixture:
                assert key not in taken, f"{key} is in {taken.get(key)} and {name}"
                taken[key] = name
                globals()[key] = obj
    return taken


@pytest.fixture
def bullet_factory():
    """Storage-less, network-less Bullets of the port, closed afterwards."""
    created = []

    def make(**options):
        opts = {"storage": False, "disable_network": True}
        opts.update(options)
        b = bullet_tpu_torch.create(opts)
        created.append(b)
        return b

    yield make
    for b in created:
        b.close()


MIRRORED_TESTS = _collect()


def test_every_reference_test_is_mirrored():
    want = set()
    for name in MIRRORED:
        want |= set(re.findall(r"^def (test_\w+)", (TESTS / f"{name}.py").read_text(), re.M))
    assert want and want <= set(MIRRORED_TESTS)
    for key in want:
        assert globals()[key].__globals__["__name__"].startswith("torch_mirror_")


def test_mirrors_build_port_objects(bullet_factory):
    assert type(bullet_factory()).__module__ == "bullet_tpu_torch.db.core"
    module = _mirror("test_storage")
    assert module.bt is bullet_tpu_torch


# --------------------------------------------------------- package entry


def test_create_returns_a_working_bullet():
    b = bullet_tpu_torch.create({"storage": False, "disable_network": True})
    try:
        assert isinstance(b, bullet_tpu_torch.Bullet)
        b.get("users/a").put({"name": "A", "age": 3})
        assert b.get("users/a").value() == {"name": "A", "age": 3}
        assert bullet_tpu_torch.VERSION == bullet_tpu.VERSION == "0.1.0"
        for name in ("Storage", "Query", "Validation", "Middleware", "Serializer",
                     "Network", "FileStorage", "PeerNetworkSim", "P", "Predicate",
                     "TableState", "BulletNode", "BulletCRT", "create"):
            obj = getattr(bullet_tpu_torch, name)
            assert obj.__module__.startswith("bullet_tpu_torch"), name
        with pytest.raises(AttributeError):
            bullet_tpu_torch.nothing_here  # noqa: B018
    finally:
        b.close()


def test_cli_help():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run([sys.executable, "-m", "bullet_tpu_torch", "--help"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.startswith("usage: bullet_tpu_torch")
    assert "serve" in done.stdout
    done = subprocess.run([sys.executable, "-m", "bullet_tpu_torch", "serve", "--help"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and "--storage" in done.stdout


# ------------------------------------------------- both packages, one fuzz

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "required": True, "min": 2, "max": 8},
        "age": {"type": "integer", "min": 0, "max": 120},
        "role": {"type": "string", "enum": ["admin", "user"]},
        "email": {"type": "string", "format": "email"},
    },
}


def _value(rng):
    kind = int(rng.integers(7))
    if kind == 0:
        return int(rng.integers(-10, 150))
    if kind == 1:
        return float(rng.integers(-40, 40)) / 4
    if kind == 2:
        return ["admin", "user", "guest", "a", "bob", "x@y.io", "nope"][int(rng.integers(7))]
    if kind == 3:
        return bool(rng.integers(2))
    if kind == 4:
        return None
    if kind == 5:
        return [int(rng.integers(5)), "t"]
    return {"name": ["al", "b", "carol", "averylongname"][int(rng.integers(4))],
            "age": int(rng.integers(-5, 130)), "role": ["admin", "user", "x"][int(rng.integers(3))]}


def _put_value(rng, path):
    """Mostly values of the shape the path's schema wants, some not."""
    if rng.random() < 0.3:
        return _value(rng)
    field = path.split("/")[2] if path.count("/") == 2 else None
    if field is None:
        return {"name": ["al", "b", "carol", "averylongname"][int(rng.integers(4))],
                "age": int(rng.integers(-5, 130)),
                "role": ["admin", "user", "x"][int(rng.integers(3))]}
    if field == "age":
        return int(rng.integers(-5, 130))
    if field == "role":
        return ["admin", "user", "x"][int(rng.integers(3))]
    return ["al", "bob", "x@y.io", "a"][int(rng.integers(4))]


def _path(rng):
    m = int(rng.integers(5))
    r = rng.random()
    if r < 0.5:
        return f"users/u{m}"
    if r < 0.8:
        return f"users/u{m}/" + ["name", "age", "role", "email"][int(rng.integers(4))]
    return f"items/i{m}"


def _errors(log):
    return [(type(e).__name__, e.type, str(e), e.is_fatal) for e in log]


def _export_body(text):
    """An export without its wall-clock stamps."""
    return re.sub(r"\d{4}-\d\d-\d\dT[\d:.]+Z?", "<time>", re.sub(r'"timestamp": ?\d+', "", text))


def _run(bt, seed, n_ops):
    """The seeded call sequence on package ``bt``; returns what it saw."""
    rng = np.random.default_rng(seed)
    b = bt.create({"storage": False, "disable_network": True})
    seen, errors = [], []
    try:
        b.define_schema("user", SCHEMA)
        b.apply_schema("users", "user")
        b.validation.on_error("all", errors.append)
        b.use("put", lambda path, data: False if path.startswith("items/i4") else None)
        b.index("users", "role")
        for i in range(n_ops):
            r = rng.random()
            if r < 0.5:
                path = _path(rng)
                b.get(path).put(_put_value(rng, path))
                seen.append(("put", path))
            elif r < 0.6:
                seen.append(("get", b.get(_path(rng)).value()))
            elif r < 0.7:
                role = ["admin", "user", "x"][int(rng.integers(3))]
                seen.append(("equals", sorted(n.path for n in b.equals("users", "role", role)),
                             b.count("users", "role", role)))
            elif r < 0.78:
                lo = int(rng.integers(0, 60))
                seen.append(("range", sorted(n.path for n in b.range("users", "age", lo, lo + 40))))
            elif r < 0.86:
                data = _value(rng)
                try:
                    seen.append(("validate", b.validate("user", data)))
                except Exception as error:  # noqa: BLE001 - compared below
                    seen.append(("validate", type(error).__name__, str(error)))
            elif r < 0.92:
                seen.append(("filter", sorted(
                    n.path for n in b.filter("users", lambda v, k: isinstance(v, dict)
                                             and isinstance(v.get("age"), int)))))
            else:
                fmt = ["json", "csv", "xml"][int(rng.integers(3))]
                out = getattr(b, f"export_to_{fmt}")("users")
                seen.append(("export", fmt, _export_body(out)))
            seen.append(("errors", len(errors)))
        exported = json.loads(b.export_to_json("users"))
        return {"store": b.store, "seen": seen, "errors": _errors(errors),
                "export": exported["data"]}
    finally:
        b.close()


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_matches_reference(seed):
    want = _run(bullet_tpu, seed, 80)
    got = _run(bullet_tpu_torch, seed, 80)
    assert got["errors"] == want["errors"]
    assert got["store"] == want["store"]
    assert got["export"] == want["export"]
    for i, (a, b) in enumerate(zip(got["seen"], want["seen"])):
        assert a == b, f"call {i}"
    assert len(got["seen"]) == len(want["seen"])
    assert want["errors"] and any(s[0] == "export" for s in want["seen"])
