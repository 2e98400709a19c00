"""The re-key of a rank1 table after a respread (``ops/rank.py``
``rekey_rank1``; on the card ``csrc/rekey_rank1.cu``) against its plain
version, and the helpers that the CPU cases in ``test_torch_rank.py`` hold
to the JAX reference: tables shaped as a respread finds them, and the count
of runs of equal ranks the kernel should search once each.

On the card (``-m card``; this file imports no JAX, so run it without the
suite's conftest: ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_rekey_rank1.py -m card -s``): the kernel against the plain
version bit for bit at 1,024 x 2^20 on a converged table after a real
respread, on a random table that is not converged (ranks the old inverse
does not hold, rank 0, negative entries, runs of every length), on the same
at a ragged width and on one 256-row shard; its search counter against the
runs counted on the host; and rank1 sims on the card, one of them a 4-shard
mesh, against a CPU twin through forced respreads. The kernel's device time
against its byte floor is ``chip_smoke.py``'s (phase 6). Tolerance: exact
(all int32)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bullet_tpu_torch import PeerNetworkSim, _build
from bullet_tpu_torch.convert import table_to_numpy
from bullet_tpu_torch.ops import rank as rk

torch.set_num_threads(2)

# the batch of new values a write batch of the cells ranks: all above every
# earlier value, so they land in the top gap of the rank space
BATCH = 256


def respread_index(rng, n_vals: int, index_type=rk.RankIndex):
    """A RankIndex of ``n_vals`` numbers just after a real respread: batches
    of BATCH values above every earlier one fill the top gap until it is
    exhausted. ``index_type`` is the port's RankIndex or the reference's."""
    idx = index_type()
    cls = np.full(n_vals, 2)
    klo = rng.integers(-(1 << 30), 1 << 30, n_vals)
    idx.insert_batch(np.arange(n_vals), cls, np.zeros(n_vals), klo)
    top, vid = int(klo.max()), n_vals
    while idx.epoch == 1:
        new = np.arange(vid, vid + BATCH)
        idx.insert_batch(new, np.full(BATCH, 2), np.zeros(BATCH), top + 1 + np.arange(BATCH))
        top, vid = top + BATCH, vid + BATCH
    assert idx.needs_rekey and idx.prev_inverse is not None
    return idx


def luts(idx, device):
    """(old sorted ranks, their vids, vid -> new rank) as int32 tensors."""
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in (*idx.prev_inverse, idx.rank_map())]


def converged_table(gen, old_sranks, p: int, n: int, live: float = 0.91):
    """A [p, n] table as a converge leaves it before a respread's re-key:
    every column one old rank in all rows, or absent (0) in about 1 - live
    of them."""
    dev = old_sranks.device
    pick = torch.randint(0, old_sranks.numel(), (n,), generator=gen, device=dev)
    held = torch.rand(n, generator=gen, device=dev) < live
    col = torch.where(held, old_sranks[pick], 0)
    return col.expand(p, n).contiguous()


def mixed_table(gen, old_sranks, p: int, n: int):
    """A [p, n] table that is not converged: down each column runs of
    random length over four candidates, drawn from the old inverse's ranks
    (hits), any int32 (ranks the inverse does not hold, negative ones among
    them) and 0, so runs restart, repeat a rank two runs back and change on
    every row."""
    dev = old_sranks.device
    kinds = torch.randint(0, 3, (4, n), generator=gen, device=dev)
    hits = old_sranks[torch.randint(0, old_sranks.numel(), (4, n), generator=gen, device=dev)]
    other = torch.randint(-(1 << 31), (1 << 31) - 1, (4, n), generator=gen, device=dev,
                          dtype=torch.int32)
    pool = torch.where(kinds == 0, hits, torch.where(kinds == 1, other, 0))
    change = torch.rand((p, n), generator=gen, device=dev) < 0.3
    run = torch.cumsum(change, 0, dtype=torch.int32)
    del change
    pick = (run * 7 + torch.arange(n, device=dev, dtype=torch.int32)) % 4
    del run
    return torch.gather(pool, 0, pick.to(torch.int64))


def run_starts(rank) -> int:
    """The searches the kernel should run on ``rank`` ([p, n], counted on
    the host): entries > 0 in the first row or unlike the row above."""
    a = np.asarray(rank.cpu() if isinstance(rank, torch.Tensor) else rank)
    total = int(np.count_nonzero(a[0] > 0))
    for r0 in range(1, a.shape[0], 64):
        block = a[r0:r0 + 64]
        total += int(np.count_nonzero((block > 0) & (block != a[r0 - 1:r0 - 1 + len(block)])))
    return total


# ---------------------------------------------------------------- the card


def _needs_card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CARD_CASES = {  # rows, columns, table
    "converged": (1024, 1 << 20, "converged"),
    "mixed": (1024, 1 << 20, "mixed"),
    "ragged": (1024, (1 << 20) - 3, "mixed"),
    "shard": (256, 1 << 20, "converged"),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(case):
    """The kernel against the plain version on the card's tensors, bit for
    bit, and its search counter against the runs counted on the host."""
    dev = _needs_card()
    p, n, kind = CARD_CASES[case]
    idx = respread_index(np.random.default_rng(26), 100_000)
    inverse = luts(idx, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2_600_000_001)
    make = converged_table if kind == "converged" else mixed_table
    before = make(gen, inverse[0], p, n)
    want = rk.rekey_rank1_torch(rk.Rank1Table(before.clone()), *inverse).rank
    got = rk.Rank1Table(before.clone())
    searches = rk.rekey_searches(dev)
    searches.zero_()
    launches = _build.LAUNCHES["rekey_rank1"]
    rk.rekey_rank1(got, *inverse)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rekey_rank1"] == launches + 1
    assert torch.equal(got.rank, want), case
    starts = run_starts(before)
    assert int(searches) == starts, (case, int(searches), starts)
    if kind == "converged":
        assert starts == int(torch.count_nonzero(before[0]))


@pytest.mark.card
@pytest.mark.parametrize("shards", [1, 4])
def test_sims_rekey_on_card(monkeypatch, shards):
    """A rank1 sim on the card (one table, or a 4-shard mesh on the one
    card) and its twin on the CPU take the same writes through forced
    respreads: the tables stay bit-identical batch for batch, and every
    respread launches the kernel once a shard."""
    dev = _needs_card()
    monkeypatch.setattr(rk, "RANK_SPAN", 4095)
    p, n = 32, 256
    mesh = {"mesh_devices": [str(dev)] * shards} if shards > 1 else {}
    card = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device=dev, **mesh)
    twin = PeerNetworkSim(p, capacity=n, topology="ring", layout="rank1", device="cpu")
    rng = np.random.default_rng(26)
    launches = _build.LAUNCHES["rekey_rank1"]
    for batch in range(8):
        peers = rng.integers(0, p, 64).astype(np.int32)
        paths = [f"u/k{int(k)}" for k in rng.integers(0, 40, 64)]
        vals = (batch * 1000 + rng.integers(0, 1000, 64)).tolist()
        for sim in (card, twin):
            for peer, path, val in zip(peers, paths, vals):
                sim.put(int(peer), path, val)
            sim.step(0)
            sim.run_until_converged()
        for a, b in zip(table_to_numpy(card.table), table_to_numpy(twin.table)):
            np.testing.assert_array_equal(a, b, f"batch {batch}")
    respreads = card.rank_index.epoch - 1
    assert respreads == twin.rank_index.epoch - 1 > 0
    assert _build.LAUNCHES["rekey_rank1"] - launches == respreads * shards
    assert card.get(0) == twin.get(0)
