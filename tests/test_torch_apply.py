"""Port apply_ops against the reference apply_ops: table and applied count,
both modes, with padded op batches. Tolerance: exact."""

import numpy as np
import pytest
import torch

from bullet_tpu.ops.apply import apply_ops as jax_apply_ops
from bullet_tpu.ops.apply import pad_ops as jax_pad_ops
from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu_torch.convert import table_from_numpy, table_to_numpy
from bullet_tpu_torch.ops.apply import apply_ops, pad_ops

torch.set_num_threads(2)


def start_table(seed, p, n):
    rng = np.random.default_rng(seed)
    ranges = ((0, 3), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 6), (0, 3))
    return [rng.integers(lo, hi, (p, n), dtype=np.int32) for lo, hi in ranges]


def op_lists(seed, p, n, max_ops):
    """Per-peer op lists with repeated slots within a peer's batch, value
    ties, negative keys and cls=0 ops (which must never land)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(p):
        k = int(rng.integers(0, max_ops + 1))
        out.append([
            (int(rng.integers(0, n)), int(rng.integers(0, 4)),
             int(rng.integers(-3, 3)), int(rng.integers(-3, 3)),
             int(rng.integers(0, 4)), int(rng.integers(0, 8)))
            for _ in range(k)
        ])
    return out


@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("p,n,max_ops,batch", [(4, 16, 6, 8), (9, 40, 12, 16), (1, 5, 3, 4)])
def test_apply_matches_reference(mode, p, n, max_ops, batch):
    table = start_table(p * 7 + n, p, n)
    ops = op_lists(p + n, p, n, max_ops)
    want, a_want = jax_apply_ops(JaxTable(*table), jax_pad_ops(ops, p, batch), 3, mode=mode)
    got, a_got = apply_ops(table_from_numpy(table, "cpu"), pad_ops(ops, p, batch, "cpu"), 3, mode=mode)
    for a, b in zip(table_to_numpy(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(a_got) == int(a_want)


def test_padding_never_lands():
    z = [np.zeros((3, 4), np.int32) for _ in range(7)]
    got, applied = apply_ops(table_from_numpy(z, "cpu"), pad_ops([[], [], []], 3, 8, "cpu"), 1)
    assert int(applied) == 0
    assert all(not a.any() for a in table_to_numpy(got))
