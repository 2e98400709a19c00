"""The reference's tests of the bridge, checkpoints, the serializer
facade, the observer and the serving tail, run on the port.

Each of ``test_engine_serializer.py``, ``test_bridge_cli.py``,
``test_checkpoint_node.py``, ``test_observe.py`` and
``test_serving_tail.py`` is compiled with ``bullet_tpu`` renamed to
``bullet_tpu_torch``, and its tests and fixtures join this module under
their own names. The sims they build go on the CPU: the entry points'
``device`` default is set to "cpu" for each test (they default to the
card). ``bullet_factory`` is this module's own and makes the port's
Bullets. ``test_cli_serve_and_speak`` runs ``python -m bullet_tpu_torch
serve`` with its own deadlines (15 s for the port, 10 s for the exit).

Left out, with the reason (``LEFT_OUT``; the guard test checks that every
other reference test is here)."""

import re
import types
from pathlib import Path

import pytest

import bullet_tpu_torch
from bullet_tpu_torch.models import bridge, checkpoint
from bullet_tpu_torch.models.netsim import PeerNetworkSim

TESTS = Path(__file__).resolve().parent
MIRRORED = ("test_engine_serializer", "test_bridge_cli", "test_checkpoint_node",
            "test_observe", "test_serving_tail")
LEFT_OUT = {
    "test_checkpoint_orbax_backend":
        "orbax is a JAX library: the port's checkpoints are npz only, and "
        "test_torch_checkpoint.py::test_orbax_is_refused checks the refusal",
}
# the entry points that build a sim, whose device default the tests set to
# the CPU
ENTRY_POINTS = (PeerNetworkSim.__init__, PeerNetworkSim.load_checkpoint,
                checkpoint.load_checkpoint, bridge.sim_from_bullet)


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
            if key in LEFT_OUT:
                continue
            is_fixture = hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ in (
                "FixtureFunctionDefinition",)
            if key.startswith("test_") and callable(obj) or is_fixture:
                assert key not in taken, f"{key} is in {taken.get(key)} and {name}"
                taken[key] = name
                globals()[key] = obj
    return taken


@pytest.fixture(autouse=True)
def _sims_on_the_cpu(monkeypatch):
    for fn in ENTRY_POINTS:
        monkeypatch.setattr(fn, "__kwdefaults__", {**fn.__kwdefaults__, "device": "cpu"})


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


def test_every_reference_test_is_mirrored_or_listed():
    want = set()
    for name in MIRRORED:
        want |= set(re.findall(r"^def (test_\w+)", (TESTS / f"{name}.py").read_text(), re.M))
    tests = {k for k in MIRRORED_TESTS if k.startswith("test_")}
    assert set(LEFT_OUT) <= want
    assert want - set(LEFT_OUT) == tests
    for key in tests:
        assert globals()[key].__globals__["__name__"].startswith("torch_mirror_")


def test_mirrors_build_port_objects_on_the_cpu(bullet_factory):
    assert type(bullet_factory()).__module__ == "bullet_tpu_torch.db.core"
    module = _mirror("test_bridge_cli")
    assert module.bt is bullet_tpu_torch
    assert module.PeerNetworkSim is PeerNetworkSim
    sim = module.PeerNetworkSim(2, capacity=64)
    assert sim.device.type == "cpu"
    assert bridge.sim_from_bullet(bullet_factory(), 2).device.type == "cpu"
