"""The dirty-column marks (``models/marks.py``): marks against the bool
columns' own reductions (16-column groups, 32-column stripes), settling
under strongly connected topologies and not under partitioned or one-way
ones, the connectivity test made once a topology, and the marks going
stale (every column dirty) after a cutoff, a width change, and on a sim
after capacity growth, a restore and untracked gossip."""

import numpy as np
import pytest
import torch

from bullet_tpu_torch import PeerNetworkSim
from bullet_tpu_torch.models.marks import ColumnMarks
from bullet_tpu_torch.parallel import topology as topo

torch.set_num_threads(2)

N, TILE = 256, 32
SLOTS = np.array([3, 40, 41, 255, 3])


def settled():
    """Marks at width (N, TILE), every column clean; and the width."""
    width = [N, TILE]
    marks = ColumnMarks(lambda: tuple(width))
    marks.settle(topo.ring(4))
    return marks, width


def marked():
    marks, width = settled()
    marks.mark(SLOTS)
    return marks, width


def want_columns():
    cols = np.zeros(N, dtype=bool)
    cols[SLOTS] = True
    return cols


def case_mark(monkeypatch):
    marks = ColumnMarks(lambda: (N, TILE))
    assert marks.columns() is None and marks.groups() is None
    assert marks.seed("cpu").tolist() == [True] * (N // TILE)
    marks.mark(SLOTS)  # stale marks stay stale
    assert marks.columns() is None
    marks, _ = marked()
    cols = want_columns()
    assert np.array_equal(marks.columns(), cols)
    assert marks.groups().tolist() == np.flatnonzero(cols.reshape(-1, 16).any(1)).tolist()
    assert marks.seed("cpu").tolist() == cols.reshape(-1, TILE).any(1).tolist()


def case_settle_connected(monkeypatch):
    tested = []
    is_connected = topo.Topology.is_connected
    monkeypatch.setattr(topo.Topology, "is_connected",
                        lambda t: tested.append(t.name) or is_connected(t))
    for whole in (topo.chain(5), topo.bridge((3, 3), 1), topo.from_adjacency(
            np.roll(np.eye(6, dtype=bool), 1, 1), name="one-way cycle")):
        marks, _ = marked()
        for _ in range(2):
            marks.settle(whole)
            assert not marks.columns().any() and marks.groups().size == 0
    # once a topology object: each marked() settles under a new ring first
    assert tested == ["ring", "chain", "ring", "bridge", "ring", "one-way cycle"]


def case_settle_partitioned(monkeypatch):
    one_way = np.eye(6, k=1, dtype=bool)  # a chain pulling one way only
    for cut in (topo.ring(6).drop_peer(3), topo.bridge((3, 3), 1).drop_peer(6),
                topo.from_adjacency(one_way, name="one-way chain")):
        marks, _ = marked()
        marks.settle(cut)
        assert np.array_equal(marks.columns(), want_columns())
        marks.finish(2, 0, 5, cut)
        assert np.array_equal(marks.columns(), want_columns())
        stale = ColumnMarks(lambda: (N, TILE))
        stale.settle(cut)
        assert stale.columns() is None


def case_finish(monkeypatch):
    ring = topo.ring(4)
    for rounds, last, cap, clean in ((5, 3, 5, False), (4, 3, 5, True), (5, 0, 5, True)):
        marks, _ = marked()
        marks.finish(rounds, last, cap, ring)
        assert (marks.columns() is not None) is clean
        if clean:
            assert not marks.columns().any()


def case_width(monkeypatch):
    marks, width = marked()
    width[0] = 2 * N  # the table grew
    assert marks.columns() is None and marks.groups() is None
    marks.mark(SLOTS)
    width[0] = N
    assert marks.columns() is None
    marks, width = settled()
    width[1] = 0  # no tracked loop at this width
    marks.settle(topo.ring(4))
    assert marks.columns() is None


def converged_sim():
    sim = PeerNetworkSim(16, capacity=256, topology="ring", layout="packed", device="cpu",
                         use_kernels=True)
    sim.put(0, "x/a", 1)
    sim.run_until_converged()
    assert not sim._marks.columns().any()
    sim.put(1, "x/a", 2)
    sim.step(0)
    assert sim._marks.columns().sum() == 1
    return sim


def case_sim_capacity(monkeypatch):
    sim = converged_sim()
    for i in range(300):
        sim.put(i % 16, f"grow/{i}", i)
    sim.step(0)
    assert sim._marks.columns() is None


def case_sim_restore(monkeypatch):
    sim = converged_sim()
    sim.restore(sim.snapshot())
    assert sim._marks.columns() is None


def case_sim_step(monkeypatch):
    sim = converged_sim()
    sim.step(1)
    assert sim._marks.columns() is None
    sim.run_until_converged()
    assert not sim._marks.columns().any()


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_marks(case, monkeypatch):
    CASES[case](monkeypatch)
