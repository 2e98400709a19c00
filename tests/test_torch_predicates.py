"""Traced predicates (bullet_tpu_torch/ops/predicates.py): the port's
``compile_predicate`` against the reference's JAX program on the same
RowView, PathStruct and params over fuzzed predicate trees (mask and count
bit-identical), and the cases of tests/test_predicates.py (the host oracle,
the leaf form, edge values, misc semantics, a fuzz) on port sims of every
layout, each also held against the reference sim given the same puts.
Tolerance: exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
from bullet_tpu.ops import predicates as jp
from bullet_tpu.ops import scans as js
from bullet_tpu_torch import P, PeerNetworkSim, Predicate
from bullet_tpu_torch.ops import predicates as pp
from bullet_tpu_torch.ops import scans as ps

torch.set_num_threads(2)

LAYOUTS = ["dense", "packed", "rank", "rank1"]
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
KEY_HALVES = np.array([I32_MIN, -7, -1, 0, 1, 5, I32_MAX], np.int32)


# ------------------------------------------------ the program, bit for bit


def random_tree(pmod, seed, depth=3):
    """A random predicate tree built from ``pmod``'s DSL; the same seed
    gives the same tree from either package."""
    rng = random.Random(seed)
    fields = ["a", "b", "c", None]  # None: the leaf form

    def field(name):
        return pmod.P.value() if name is None else pmod.P[name]

    def atom():
        f = rng.choice(fields)
        r = rng.random()
        if r < 0.3:
            op = rng.choice(["__lt__", "__le__", "__gt__", "__ge__"])
            return getattr(field(f), op)(rng.choice([-5, 0, 1, 2.5, 1e300, float("nan")]))
        if r < 0.45:
            return field(f).between(rng.randint(-10, 5), rng.randint(-5, 60))
        if r < 0.8:
            return field(f) == rng.choice([1, 2.5, "x", True, None])
        if r < 0.9:
            return field(f) != rng.choice([0, "y"])
        return pmod.P.has(f or "a")

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


def random_row(rng, n):
    cls = rng.integers(0, 5, n)
    row = [cls, rng.choice(KEY_HALVES, n), rng.choice(KEY_HALVES, n),
           np.where(cls > 0, rng.integers(0, 9, n), 0)]
    parent = rng.integers(-1, 8, n)
    struct = [parent, np.where(parent >= 0, rng.integers(-1, 4, n), -1), rng.integers(-1, 4, n)]
    return [np.ascontiguousarray(a, dtype=np.int32) for a in row + struct]


@pytest.mark.parametrize("seed", range(8))
def test_compile_predicate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    arrays = random_row(rng, n)
    jrow, jst = js.RowView(*map(jnp.asarray, arrays[:4])), js.PathStruct(*map(jnp.asarray, arrays[4:]))
    prow = ps.RowView(*(torch.from_numpy(a.copy()) for a in arrays[:4]))
    pst = ps.PathStruct(*(torch.from_numpy(a.copy()) for a in arrays[4:]))
    for k in range(10):
        tseed = 1000 * seed + k
        jpred, ppred = random_tree(jp, tseed), random_tree(pp, tseed)
        assert ppred.signature() == jpred.signature()
        # random field ids and vids (-1: a None probe), the key intervals
        # the atoms give
        lookups = random.Random(tseed)
        seg = lambda f: lookups.randint(-1, 3)  # noqa: E731
        enc = lambda v: (0, 0, 0, lookups.randint(0, 9))  # noqa: E731
        params = jp.predicate_params(jpred, seg, enc)
        lookups = random.Random(tseed)
        assert pp.predicate_params(ppred, seg, enc) == params
        for base in (-1, 0, 3):
            jmask, jcount = jp.compile_predicate(jpred)(
                jrow, jst, jnp.int32(base), jnp.asarray(params, dtype=jnp.int32))
            pmask, pcount = pp.compile_predicate(ppred)(
                prow, pst, base, torch.tensor(params, dtype=torch.int32))
            assert pmask.dtype == torch.bool and pcount.dtype == torch.int32
            np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask), ppred.signature())
            assert int(pcount) == int(jcount)
        assert pp.compile_predicate(ppred) is pp.compile_predicate(random_tree(pp, tseed))


def test_child_level_scatter_is_an_or():
    """Many field slots under each child of the base, true and false mixed
    in every order: a child is true iff one of its slots is."""
    n, base = 64, 63
    i = torch.arange(n, dtype=torch.int32)
    kids, slots = i < 4, (i >= 4) & (i < 60)
    parent = torch.where(kids, base, torch.where(slots, i % 4, -1)).to(torch.int32)
    parent2 = torch.where(slots, base, -1).to(torch.int32)
    struct = ps.PathStruct(parent, parent2, torch.zeros(n, dtype=torch.int32))
    vid = torch.zeros(n, dtype=torch.int32)
    vid[torch.tensor([5, 59, 6, 58])] = 3  # parents 1, 3, 2, 2
    row = ps.RowView(torch.full((n,), 2, dtype=torch.int32), vid, vid, vid)
    mask, count = pp.compile_predicate(P["f"] == 1)(
        row, struct, base, torch.tensor([0, 3], dtype=torch.int32))
    assert mask.nonzero().flatten().tolist() == [1, 2, 3] and int(count) == 3


# ------------------------------------------ the sims: tests/test_predicates.py


def sims(layout, capacity=512, peers=2):
    return (JaxSim(peers, capacity=capacity, layout=layout),
            PeerNetworkSim(peers, capacity=capacity, layout=layout, device="cpu"))


USERS = {
    "u1": {"name": "Alice", "age": 28, "active": True, "score": 9.5},
    "u2": {"name": "Bob", "age": 35, "active": True},
    "u3": {"name": "Carol", "age": 42, "active": False, "score": 3},
    "u4": {"name": "Dave", "active": True, "score": 0},
    "u5": {"name": "Eve", "age": 31, "nested": {"deep": 1}},
    "u6": {"name": "Frank", "age": True},  # bool-typed age (JS coercion)
}


def host_expected(sim, peer, base, pred):
    """The host oracle: ``pred.evaluate`` of every child of ``base`` that
    the path interner knows, its value decoded at ``peer`` by ``get``, None
    where the peer's row holds none of it. That is the device program's
    semantics, the reference's as well: a negation matches a child that
    another peer wrote and this one has not received."""
    pid = sim.host.paths.lookup(base)
    if pid is None:
        return []
    data = sim.get(peer, base)
    data = data if isinstance(data, dict) else {}
    kids = np.flatnonzero(sim.host.struct_np()[0] == pid)
    segs = (sim.host.paths.segment(int(c)) for c in kids)
    return sorted(f"{base}/{k}" for k in segs if pred.evaluate(data.get(k)))


def check(pair, peer, base, ppred, jpred):
    """The port's filter and count == the host oracle == the reference's."""
    jsim, psim = pair
    want = host_expected(psim, peer, base, ppred)
    got = psim.filter(peer, base, ppred)
    assert got == want, f"{ppred.signature()}: {got} != {want}"
    assert got == jsim.filter(peer, base, jpred), ppred.signature()
    assert psim.count(peer, base, ppred) == len(want) == jsim.count(peer, base, jpred)


def field_preds(P):
    return [
        P["age"] > 25,
        P["age"] >= 31,
        P["age"] < 35,
        P["age"].between(28, 35),
        P["name"] == "Bob",
        P["active"] == True,  # noqa: E712 - DSL, not comparison
        P["active"] == 1,  # bool vid != number vid: matches nothing
        (P["age"] > 25) & (P["active"] == True),  # noqa: E712
        (P["age"] > 40) | (P["score"] >= 9),
        ~(P["age"] > 25),  # includes children missing age
        ~P.has("score"),
        P.has("nested"),  # subtree, not a leaf: matches nothing
        P["age"] != 28,
        (P["name"] == "Zed") | ~(P["score"] < 100),
        P["age"] > 0,  # bool age coerces: true > 0
    ]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_field_predicates_match_oracle(layout):
    pair = sims(layout)
    for s in pair:
        for uid, rec in USERS.items():
            s.put(0, f"users/{uid}", rec)
        s.step(rounds=0)
    for ppred, jpred in zip(field_preds(P), field_preds(jp.P)):
        check(pair, 0, "users", ppred, jpred)
    jsim, psim = pair
    assert psim.find(0, "users", P["age"] > 100) is None
    want = host_expected(psim, 0, "users", P["age"] > 30)[0]
    assert psim.find(0, "users", P["age"] > 30) == want == jsim.find(0, "users", jp.P["age"] > 30)


@pytest.mark.parametrize("layout", ["dense", "rank1"])
def test_leaf_form_predicates(layout):
    pair = sims(layout)
    for s in pair:
        for k, v in {"a": 10, "b": 55.5, "c": 90, "d": "n/a", "e": True}.items():
            s.put(0, f"scores/{k}", v)
        s.step(rounds=0)
    for make in (lambda P: P.value() >= 55, lambda P: P.value() < 11,
                 lambda P: P.value() == "n/a", lambda P: ~(P.value() > 50),
                 lambda P: P.value().between(10, 90)):
        check(pair, 0, "scores", make(P), make(jp.P))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_predicate_edge_values(layout):
    pair = sims(layout)
    vals = {"nan": float("nan"), "inf": float("inf"), "ninf": float("-inf"), "zero": 0,
            "negzero": -0.0, "tiny": 5e-324, "big": 1.5e308, "one": 1, "true": True}
    for s in pair:
        for k, v in vals.items():
            s.put(0, f"n/{k}", {"v": v})
        s.step(rounds=0)
    cases = [
        lambda P: P["v"] > 0,  # excludes NaN, includes inf/tiny/big/true
        lambda P: P["v"] >= float("-inf"),  # everything numeric except NaN
        lambda P: P["v"] < float("inf"),
        lambda P: P["v"] > float("inf"),  # nothing
        lambda P: P["v"] == float("nan"),  # all NaNs are one encoded value
        lambda P: P["v"] == 0,  # -0.0 and 0 are one canonical value
        lambda P: P["v"] == 1,  # number 1, NOT True
        lambda P: P["v"] == True,  # noqa: E712 - True, NOT 1
        lambda P: P["v"] <= 0,
        lambda P: P["v"].between(float("nan"), 5),  # NaN bound: empty
    ]
    for make in cases:
        check(pair, 0, "n", make(P), make(jp.P))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_predicate_misc_semantics(layout):
    jsim, sim = pair = sims(layout)
    for s in pair:
        s.put(0, "users/u1", {"age": 30, "note": None})
        s.step(rounds=0)
    # null leaves decode as absent: == None matches nothing, has() is False
    assert sim.filter(0, "users", P["note"] == None) == []  # noqa: E711
    assert sim.filter(0, "users", P.has("note")) == []
    # unknown field / unknown base
    assert sim.filter(0, "users", P["ghost"] > 1) == []
    assert sim.filter(0, "nowhere", P["age"] > 1) == []
    assert sim.count(0, "nowhere", P["age"] > 1) == 0
    assert sim.find(0, "nowhere", P["age"] > 1) is None
    assert sim.count(0, "users", P["age"] == 30) == jsim.count(0, "users", jp.P["age"] == 30) == 1
    # predicates have no truth value (catches accidental `and`/`or`)
    with pytest.raises(TypeError):
        bool(P["age"] > 1)
    with pytest.raises(TypeError):
        (P["age"] > 1) and (P["age"] < 2)
    with pytest.raises(TypeError):
        P["age"] & 3
    with pytest.raises(TypeError):
        P["age"] == {"a": 1}


def fuzz_value(rng):
    r = rng.random()
    if r < 0.35:
        return rng.choice([-5, 0, 1, 2.5, 42, 1e9, -0.0, 7])
    if r < 0.5:
        return rng.choice(["x", "y", "zz", ""])
    if r < 0.6:
        return rng.choice([True, False])
    if r < 0.7:
        return None
    if r < 0.8:
        return {"inner": rng.randint(0, 3)}
    return rng.uniform(-100, 100)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_predicate_fuzz_vs_oracle(layout, seed):
    rng = random.Random(1000 + seed)
    pair = sims(layout, capacity=2048)
    fields = ["a", "b", "c", "d"]
    records = []
    for i in range(60):
        rec = {f: fuzz_value(rng) for f in fields if rng.random() < 0.7}
        records.append((rng.randrange(2), f"items/i{i}", rec or {"a": 1}))
    for s in pair:
        for peer, path, rec in records:
            s.put(peer, path, rec)
        s.step(rounds=0)
    # rows differ between the peers before the converge, not after
    for converge in (False, True):
        if converge:
            for s in pair:
                s.run_until_converged()
        for peer in range(2):
            for k in range(10):
                tseed = 7000 * seed + 100 * peer + k + 50 * converge
                ppred, jpred = random_tree(pp, tseed, 2), random_tree(jp, tseed, 2)
                assert isinstance(ppred, Predicate)
                check(pair, peer, "items", ppred, jpred)
