"""Port merge (plain version, and the kernel wrapper on CPU tensors)
against the reference: merge_tables_xla and merge_tables_pallas in
interpret mode. Tolerance: exact (int32 fields and counts)."""

import numpy as np
import pytest
import torch

from bullet_tpu.ops.merge import TableState as JaxTable
from bullet_tpu.ops.merge import merge_tables_pallas, merge_tables_xla
from bullet_tpu_torch.convert import table_from_numpy, table_to_numpy
from bullet_tpu_torch.ops.merge import init_table, merge_tables, merge_tables_torch

torch.set_num_threads(2)

RANGES = ((0, 4), (-3, 3), (-3, 3), (0, 4), (0, 4), (0, 4), (0, 5))


def fields(seed, p, n):
    """Many ties: small ranges, negative khi/klo, cls=0 entries with
    nonzero other fields."""
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, (p, n), dtype=np.int32) for lo, hi in RANGES]


def assert_tables_equal(port, ref):
    for a, b in zip(table_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
def test_merge_matches_pallas_interpret(mode, shape):
    a, b = fields(1, *shape), fields(2, *shape)
    want, c_want = merge_tables_pallas(JaxTable(*a), JaxTable(*b), mode=mode, interpret=True)
    for fn in (merge_tables, merge_tables_torch):
        got, c_got = fn(table_from_numpy(a, "cpu"), table_from_numpy(b, "cpu"), mode)
        assert_tables_equal(got, want)
        assert int(c_got) == int(c_want)


@pytest.mark.parametrize("mode", ["reference", "lww"])
@pytest.mark.parametrize("shape", [(1, 1), (3, 130), (5, 77), (64, 1000)])
def test_merge_matches_xla_ragged(mode, shape):
    a, b = fields(3, *shape), fields(4, *shape)
    want, c_want = merge_tables_xla(JaxTable(*a), JaxTable(*b), mode)
    for fn in (merge_tables, merge_tables_torch):
        got, c_got = fn(table_from_numpy(a, "cpu"), table_from_numpy(b, "cpu"), mode)
        assert_tables_equal(got, want)
        assert int(c_got) == int(c_want)
        assert c_got.dtype == torch.int32


def test_merge_negative_keys_lose_to_absent_only_when_smaller():
    """Signed compare: cls=0 with khi<0 loses to an all-zero entry in
    reference mode (the chain-end case)."""
    a = [np.zeros((1, 2), np.int32) for _ in range(7)]
    b = [np.zeros((1, 2), np.int32) for _ in range(7)]
    a[1][0, 0] = -1  # a: (0, -1, ...) < zero entry b
    a[1][0, 1] = 1   # a: (0, 1, ...) > zero entry b
    got, c = merge_tables(table_from_numpy(a, "cpu"), table_from_numpy(b, "cpu"))
    assert table_to_numpy(got)[1].tolist() == [[0, 1]]
    assert int(c) == 1


def test_init_table_fields_are_separate_allocations():
    t = init_table(2, 4, "cpu")
    t.cls[0, 0] = 7
    assert all(int(f[0, 0]) == 0 for f in t[1:])


def test_merge_rejects_unknown_mode():
    t = init_table(1, 1, "cpu")
    with pytest.raises(ValueError):
        merge_tables(t, t, "newest")
