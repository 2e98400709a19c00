"""The window join (bullet_tpu_torch/ops/packed.py ring_window_packed*)
against the reference's: ``ring_window_packed_xla`` for every field count
(3 = packed, 2 = rank, 1 = rank1), ring and chain, small and ragged P
(including P in {1, 2, 3}, where rows p-1 and p+1 are one row), depths past
P, and P = 4096; the interpret-mode Pallas window kernels (#12 full-P
stripe and #17 halo tiles); and m sequential plain rounds. The reference's
XLA window runs with jit disabled (op by op), which keeps the many shapes
cheap. Tolerance: exact (int32 tables and the round-m residual)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bullet_tpu.ops import packed as jpk
from bullet_tpu.ops import rank as jrk
from bullet_tpu_torch.convert import FROM_NUMPY, table_to_numpy
from bullet_tpu_torch.ops import packed as pk

torch.set_num_threads(2)

LAYOUT = {1: "rank1", 2: "rank", 3: "packed"}
JAX_TABLE = {1: jrk.Rank1Table, 2: jrk.RankTable, 3: jpk.PackedTable}
DEPTHS = (1, 2, 3, 7, 13, 40, 120)


def fields_np(nf, p, n, seed):
    """A packed-family table in which equal keys mean equal entries, as in
    every sim: rank1 ranks; rank (rank, cv) with cv a function of the
    rank; packed (khi, klo, cv) with many ties, absent entries all-zero."""
    rng = np.random.default_rng(seed)
    if nf == 3:
        cls = rng.integers(0, 3, (p, n))
        vid = rng.integers(0, 40, (p, n))
        key = lambda: np.where(cls > 0, rng.integers(-3, 3, (p, n)), 0).astype(np.int32)
        return [key(), key(), np.where(cls > 0, (cls << 28) | vid, 0).astype(np.int32)]
    rank = np.where(rng.random((p, n)) < 0.6, rng.integers(1, 1 << 30, (p, n)), 0)
    rank = rank.astype(np.int32)
    if nf == 1:
        return [rank]
    return [rank, np.where(rank > 0, (1 << 28) | (rank & jpk.VID_MASK), 0).astype(np.int32)]


def tie_np(p, n, seed):
    """Packed fields with absent (cls 0) entries whose keys are nonzero and
    sometimes negative: a chain end's all-zero row beats them."""
    rng = np.random.default_rng(seed)
    cls, vid = rng.integers(0, 3, (p, n)), rng.integers(0, 4, (p, n))
    return [rng.integers(-3, 3, (p, n), dtype=np.int32),
            rng.integers(-3, 3, (p, n), dtype=np.int32),
            ((cls << 28) | vid).astype(np.int32)]


def jt(fields):
    return JAX_TABLE[len(fields)](*(jnp.asarray(f) for f in fields))


def pt(fields):
    return FROM_NUMPY[LAYOUT[len(fields)]](fields, "cpu")


def check(port, c_port, ref, c_ref, msg=""):
    for a, b in zip(table_to_numpy(port), ref):
        np.testing.assert_array_equal(a, np.asarray(b), msg)
    assert int(c_port) == int(c_ref), msg


def test_window_chain_matches_reference():
    for m in range(300):
        assert pk._window_chain(m) == jpk._window_chain(m)
    assert pk._window_chain(119) == [1, 3, 9, 27, 79]


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_window_matches_xla(nf, wrap):
    """Every depth at every small P, and depths past P (m = 2P + 3, where a
    ring's arcs overlap and a chain clamps every shifted row)."""
    with jax.disable_jit():
        for p in (1, 2, 3, 8, 64):
            for m in (*DEPTHS, p + 1, 2 * p + 3):
                f = fields_np(nf, p, 130, seed=p * 1000 + m)
                want, c_want = jpk.ring_window_packed_xla(jt(f), wrap, m)
                got, c_got = pk.ring_window_packed(pt(f), wrap, m)
                check(got, c_got, want, c_want, f"P={p} m={m}")


@pytest.mark.parametrize("wrap", [True, False])
def test_window_tie_table_matches_xla(wrap):
    """Absent entries with negative keys, which a chain's zero rows beat:
    the port clamps exactly where the reference clamps."""
    with jax.disable_jit():
        for p, m in ((1, 3), (3, 2), (8, 7), (64, 13), (64, 120)):
            f = tie_np(p, 96, seed=m)
            want, c_want = jpk.ring_window_packed_xla(jt(f), wrap, m)
            got, c_got = pk.ring_window_packed(pt(f), wrap, m)
            check(got, c_got, want, c_want, f"P={p} m={m}")


@pytest.mark.parametrize("nf", [1, 3])
def test_window_big_p_matches_xla(nf):
    """P = 4096, where the TPU needed the halo tiles (#17)."""
    with jax.disable_jit():
        for wrap, m in ((True, 1), (True, 13), (False, 120)):
            f = fields_np(nf, 4096, 128, seed=m)
            want, c_want = jpk.ring_window_packed_xla(jt(f), wrap, m)
            got, c_got = pk.ring_window_packed(pt(f), wrap, m)
            check(got, c_got, want, c_want, f"m={m} wrap={wrap}")


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_window_matches_interpret_kernels(nf, wrap):
    """The full-P stripe kernel (#12) at m = 7 and the halo kernel (#17)
    at m = 13 with (16, 128) tiles, as tests/test_rank1_kernels.py runs
    them, and m sequential plain rounds with the last one's residual."""
    f = fields_np(nf, 16, 512, seed=6)
    want, c_want = jpk.ring_window_packed_traced(jt(f), wrap, 7, True)
    got, c_got = pk.ring_window_packed(pt(f), wrap, 7)
    check(got, c_got, want, c_want, "full-P m=7")
    seq = pt(f)
    for _ in range(7):
        seq, c_seq = pk.packed_round_torch(seq, wrap)
    check(got, c_got, table_to_numpy(seq), c_seq, "7 sequential rounds")

    f = fields_np(nf, 64, 256, seed=19)
    want, c_want = jpk.ring_window_halo_packed_traced(jt(f), wrap, 13, True, tiles=(16, 128))
    got, c_got = pk.ring_window_packed(pt(f), wrap, 13)
    check(got, c_got, want, c_want, "halo m=13")


@pytest.mark.parametrize("nf", [1, 2, 3])
def test_window_equals_sequential_rounds(nf):
    """m window rounds == m classic rounds (state, and the last round's
    residual), ring and chain, up to past the fixed point."""
    for wrap in (True, False):
        f = fields_np(nf, 24, 64, seed=nf)
        seq = pt(f)
        for m in range(1, 30):
            seq, c_seq = pk.packed_round_torch(seq, wrap)
            if m in (1, 2, 5, 12, 13, 29):
                got, c_got = pk.ring_window_packed(pt(f), wrap, m)
                check(got, c_got, table_to_numpy(seq), c_seq, f"m={m} wrap={wrap}")
    assert int(c_seq) == 0  # 29 rounds pass a 24-chain's fixed point


def test_window_wrapper_checks():
    t = pt(fields_np(1, 4, 32, 0))
    with pytest.raises(ValueError, match="m must be"):
        pk.ring_window_packed(t, True, 0)
    with pytest.raises(ValueError, match="m must be"):
        pk.ring_window_packed_torch(t, True, 0)
    meta = FROM_NUMPY["rank1"](fields_np(1, 4, 32, 0), "meta")
    with pytest.raises(ValueError):  # neither a kernel nor a plain version
        pk.ring_window_packed(meta, True, 3)


# ---------------------------------------- the kernel's schedule (its model)

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _kernel_models as km  # noqa: E402

MODEL_PS = (1, 2, 3, 17, 64, 1000)


def model_depths(p):
    """The depths the kernel model is held at on a P-row table: fixed
    ones, both sides of P/2 (where a ring's window becomes the whole
    column) and past P."""
    return sorted({1, 2, 3, 13, 120, max(1, p // 2), p // 2 + 1, p + 1, 2 * p + 3})


def np_fields(f):
    return [torch.from_numpy(np.array(x, dtype=np.int32)) for x in f]


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("p", MODEL_PS)
def test_window_model_matches_xla(nf, wrap, p):
    """window_packed.cu's schedule (tests/_kernel_models.py window_model:
    blocks of the kernel's column count, 37 columns so the last block is
    ragged, the 3-way doubling joins on PipeKey words, the clip, the final
    round) and the plain version against the reference's XLA window, at
    every depth of ``model_depths``; packed chains also on the tie table
    (absent entries with negative keys, which only a clip keeps)."""
    tables = [fields_np(nf, p, 37, seed=p * 7 + nf)]
    if nf == 3:
        tables.append(tie_np(p, 37, seed=p))
    with jax.disable_jit():
        for f in tables:
            for m in model_depths(p):
                want, c_want = jpk.ring_window_packed_xla(jt(f), wrap, m)
                got = np_fields(f)
                c_got = km.window_model(got, None, None, m, km.WRAP if wrap else
                                        km.CLIP_TOP | km.CLIP_BOTTOM)
                check(got, c_got, want, c_want, f"model P={p} m={m}")
                plain, c_plain = pk.ring_window_packed_torch(pt(f), wrap, m)
                check(plain, c_plain, want, c_want, f"plain P={p} m={m}")


@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("cols", [1, 2, 4, 16])
def test_window_model_block_width(nf, cols):
    """Every block width the host code may pick gives the same bits and
    count: 29 columns leave a ragged last block at each."""
    for wrap in (True, False):
        f = fields_np(nf, 17, 29, seed=cols)
        want, c_want = pk.ring_window_packed_torch(pt(f), wrap, 9)
        got = np_fields(f)
        c_got = km.window_model(got, None, None, 9,
                                km.WRAP if wrap else km.CLIP_TOP | km.CLIP_BOTTOM, cols)
        check(got, c_got, table_to_numpy(want), c_want, f"wrap={wrap}")


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_window_row_tiles_match_xla(nf, wrap):
    """A table taller than one launch takes: row tiles of the extended
    form with slabs copied before the first launch (wrapped on a ring;
    clamped, and the edge tiles clipped, on a chain), in passes of at most
    rows / 4 rounds; the model launches each tile."""
    with jax.disable_jit():
        for p, rows, m in ((17, 7, 1), (17, 7, 3), (17, 9, 13), (64, 12, 5), (64, 31, 13),
                           (64, 40, 120), (1000, 300, 120), (1000, 600, 1001)):
            f = fields_np(nf, p, 21, seed=p + m)
            want, c_want = jpk.ring_window_packed_xla(jt(f), wrap, m)
            got = np_fields(f)
            c_got = pk.window_tiled_passes(got, wrap, m, rows, km.window_model_launch())
            check(got, c_got, want, c_want, f"P={p} rows={rows} m={m}")


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_window_model_matches_interpret_kernels(nf, wrap):
    """The model against the full-P stripe kernel (#12, m = 7) and, as
    row tiles of its extended form, against the halo kernel (#17, m = 13
    with (16, 128) tiles), both in interpret mode."""
    f = fields_np(nf, 16, 512, seed=6)
    want, c_want = jpk.ring_window_packed_traced(jt(f), wrap, 7, True)
    got = np_fields(f)
    c_got = km.window_model(got, None, None, 7,
                            km.WRAP if wrap else km.CLIP_TOP | km.CLIP_BOTTOM)
    check(got, c_got, want, c_want, "full-P m=7")

    f = fields_np(nf, 64, 256, seed=19)
    want, c_want = jpk.ring_window_halo_packed_traced(jt(f), wrap, 13, True, tiles=(16, 128))
    got = np_fields(f)
    c_got = pk.window_tiled_passes(got, wrap, 13, 2 * 13 + 16, km.window_model_launch())
    check(got, c_got, want, c_want, "halo m=13")


def test_window_block_width_and_rows():
    """The host code's choices on an H100 (the model of pick_cols and
    bt_window_rows): at 1024 rows a block takes 8 columns (two blocks an
    SM at rank1, one at rank and packed); every choice fits; rank1 at 8192
    rows takes one column; the launch limits in rows."""
    assert [km.window_cols(nf, 1024) for nf in (1, 2, 3)] == [8, 8, 8]
    assert km.window_cols(1, 8192) == 1
    assert [km.window_rows(nf) for nf in (1, 2, 3)] == [28928, 14464, 9642]
    for nf in (1, 2, 3):
        rows = km.window_rows(nf)
        assert km.window_cols(nf, rows) == 1 and km.window_cols(nf, rows + 1) is None
        for length in (1, 3, 768, 1024, 4096, 8192):
            if length <= rows:
                c = km.window_cols(nf, length)
                assert 2 * nf * length * 4 * c + km.WINDOW_RESERVED <= km.H100_SMEM_OPTIN
