"""The harness's tiny cells with the card's routes forced on the CPU
(``PeerNetworkSim._card_routes`` patched), so that an uncapped converge
takes the column pass (``gossip_columns_packed``, its plain version here):
sound runs come out correct through it, and the control, whose converges
are capped below the diameter, keeps the fused frontier loop and still
comes out not correct."""

from __future__ import annotations

import pytest

from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.ops import packed as pk
from test_perfbench_harness import TINY_CELLS, run, tiny_root  # noqa: F401 (a fixture)


@pytest.fixture
def routes(monkeypatch):
    """Forces the card's routes; counts the column passes and frontier loops."""
    monkeypatch.setattr(PeerNetworkSim, "_card_routes", lambda self: True)
    seen = {"columns": 0, "stripes": 0}
    for key, name in (("columns", "gossip_columns_packed"), ("stripes", "gossip_frontier_packed")):
        real = getattr(pk, name)

        def counted(*args, _real=real, _key=key, **kw):
            seen[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(pk, name, counted)
    return seen


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_cells_take_the_column_pass(tiny_root, routes, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert routes["columns"] > 1 and routes["stripes"] == 0


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_control_keeps_the_frontier_loop(tiny_root, routes, cell):
    res = run(tiny_root, cell, control="cutoff")
    assert not res["correct"]
    assert res["checks"]["replicas_differing"]["value"] > 0
    # the load's converge takes the pass, every capped one the frontier loop
    assert routes["columns"] == 1 and routes["stripes"] > 0
