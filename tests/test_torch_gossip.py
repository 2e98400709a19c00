"""Port gossip rounds and the convergence loop against the reference's XLA
rounds and gossip_until_converged_device: ring, chain, mesh, star and a
generic (bridge) adjacency, tables, changed counts, rounds and
last_changed. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.parallel import topology as jax_topo
from bullet_tpu.parallel.gossip import gossip_round as jax_gossip_round
from bullet_tpu.parallel.gossip import gossip_until_converged_device
from bullet_tpu_torch.convert import table_from_numpy, table_to_numpy
from bullet_tpu_torch.parallel import topology as topo
from bullet_tpu_torch.parallel.gossip import gossip_round, gossip_until_converged

torch.set_num_threads(2)


def sparse_fields(seed, p, n):
    rng = np.random.default_rng(seed)
    cls = (rng.random((p, n)) < 0.1) * rng.integers(1, 4, (p, n))
    present = cls > 0

    def m(lo, hi):
        return np.where(present, rng.integers(lo, hi, (p, n)), 0).astype(np.int32)

    return [cls.astype(np.int32), m(-20, 20), m(-20, 20), m(0, 10),
            m(0, p), m(0, 6), m(0, 5)]


def assert_tables_equal(port, ref):
    for a, b in zip(table_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def topologies(name, p):
    """The same topology from the reference module and the port's."""
    if name == "bridge":
        return jax_topo.bridge((5, 5), 1), topo.bridge((5, 5), 1)
    fn = "full_mesh" if name == "mesh" else name
    return getattr(jax_topo, fn)(p), getattr(topo, fn)(p)


def test_topology_is_the_reference_source():
    """The port keeps its own copy of the reference's topology module (a
    file of its own, so that it imports nothing of the JAX package) with
    the reference's source code."""
    import inspect

    import bullet_tpu.parallel.topology as ref

    ours = topo.ring(9)
    theirs = ref.ring(9)
    np.testing.assert_array_equal(ours.neighbors, theirs.neighbors)
    assert (ours.kind, ours.diameter) == (theirs.kind, theirs.diameter)
    assert topo.__file__ != ref.__file__
    for name in ("Topology", "ring", "chain", "full_mesh", "star", "bridge",
                 "from_adjacency", "random_graph"):
        assert inspect.getsource(getattr(topo, name)) == inspect.getsource(getattr(ref, name))


@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("name", ["ring", "chain", "mesh", "star", "bridge"])
def test_one_round_matches_reference(name, mode):
    p, n = 11, 96
    jt, pt = topologies(name, p)
    p = jt.num_peers
    t = sparse_fields(3, p, n)
    want, c_want = jax_gossip_round(JaxTable(*t), jt, mode, use_pallas=False)
    got, c_got = gossip_round(table_from_numpy(t, "cpu"), pt, mode)
    assert_tables_equal(got, want)
    assert int(c_got) == int(c_want)


@pytest.mark.parametrize("max_rounds", [0, 3, 40])
@pytest.mark.parametrize("name,mode", [
    ("ring", "reference"), ("chain", "lww"), ("mesh", "reference"),
    ("star", "lww"), ("bridge", "reference"),
])
def test_until_converged_matches_reference(name, mode, max_rounds):
    p, n = 12, 64
    jt, pt = topologies(name, p)
    p = jt.num_peers
    t = sparse_fields(4, p, n)
    want, r_want, c_want = gossip_until_converged_device(
        JaxTable(*(jnp.asarray(f) for f in t)), jnp.asarray(jt.neighbors),
        jt.kind, mode, max_rounds,
    )
    got, r_got, c_got = gossip_until_converged(
        table_from_numpy(t, "cpu"), pt, mode, max_rounds
    )
    assert_tables_equal(got, want)
    assert (r_got, c_got) == (int(r_want), int(c_want))
