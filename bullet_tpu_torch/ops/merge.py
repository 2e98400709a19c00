"""The CRT merge: a lexicographic-max select over encoded tables.

Merging two replica tables is an elementwise winner-select under a total
order (a join-semilattice, so gossip order cannot change the fixed point):

* ``mode="reference"`` — priority ``(cls, khi, klo, vid, writer, ctr)``.
* ``mode="lww"``       — priority ``(ctr, cls, khi, klo, vid, writer)``.

Lean gossip (reference mode) merges only the value keys ``(cls, khi, klo,
vid)`` in that order and leaves writer, ctr and tick alone.

``merge_tables_torch`` / ``merge_lean_torch`` are the plain PyTorch
versions; ``merge_tables`` / ``merge_lean`` run the CUDA kernel
(``csrc/merge.cu``) on CUDA tensors and the plain version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .. import _build

FIELDS = ("cls", "khi", "klo", "vid", "writer", "ctr", "tick")
# the fields lean gossip exchanges and compares, in priority order
LEAN_FIELDS = FIELDS[:4]


class TableState(NamedTuple):
    """One replica table per simulated peer: all tensors int32 [P, N].

    ``cls/khi/klo/vid`` encode the leaf value (utils/encode.py);
    ``writer`` is the peer id of the winning write, ``ctr`` its Lamport
    counter, ``tick`` the sim step of last modification.
    """

    cls: torch.Tensor
    khi: torch.Tensor
    klo: torch.Tensor
    vid: torch.Tensor
    writer: torch.Tensor
    ctr: torch.Tensor
    tick: torch.Tensor


def lean_fields(table: TableState) -> Tuple[torch.Tensor, ...]:
    """The four value-key tensors of a dense table (views, not copies)."""
    return tuple(table[:4])


def init_table(num_peers: int, capacity: int, device) -> TableState:
    """All-absent table (cls=0 loses to every real value). Every field is
    its own allocation: the kernels update fields in place."""
    return TableState(*(
        torch.zeros((num_peers, capacity), dtype=torch.int32, device=device)
        for _ in FIELDS
    ))


def priority_keys(t: TableState, mode: str) -> Tuple[torch.Tensor, ...]:
    if mode == "reference":
        return (t.cls, t.khi, t.klo, t.vid, t.writer, t.ctr)
    if mode == "lww":
        return (t.ctr, t.cls, t.khi, t.klo, t.vid, t.writer)
    raise ValueError(f"unknown merge mode: {mode}")


def lex_gt(a_keys: Sequence[torch.Tensor], b_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise ``a > b`` under lexicographic order of the key chain."""
    gt = torch.zeros(a_keys[0].shape, dtype=torch.bool, device=a_keys[0].device)
    eq = torch.ones_like(gt)
    for a, b in zip(a_keys, b_keys):
        gt |= eq & (a > b)
        eq &= a == b
    return gt


def merge_tables_torch(
    a: TableState, b: TableState, mode: str = "reference"
) -> Tuple[TableState, torch.Tensor]:
    """Plain version: winner-select + the count of entries where ``b``
    strictly beat ``a`` (an int32 scalar tensor, wrapping like int32)."""
    take_b = lex_gt(priority_keys(b, mode), priority_keys(a, mode))
    merged = TableState(*(torch.where(take_b, fb, fa) for fa, fb in zip(a, b)))
    return merged, take_b.sum(dtype=torch.int64).to(torch.int32)


def merge_tables(
    a: TableState, b: TableState, mode: str = "reference"
) -> Tuple[TableState, torch.Tensor]:
    """Merge two tables: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns new tensors and the strict-win count."""
    if mode not in ("reference", "lww"):
        raise ValueError(f"unknown merge mode: {mode}")
    device = a.cls.device
    if device.type == "cpu":
        return merge_tables_torch(a, b, mode)
    _build.require_cuda(device, "merge_tables")
    shape = a.cls.shape
    _build.check_fields((*a, *b), shape, device, "merge_tables")
    lib = _build.library()
    out = TableState(*(torch.empty_like(f) for f in a))
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_merge(
            _build.pointers(a), _build.pointers(b), _build.pointers(out),
            count.data_ptr(), a.cls.numel(), int(mode == "lww"), len(FIELDS),
            _build.stream_of(device),
        )
    _build.check(err, "merge_tables")
    _build.LAUNCHES["merge"] += 1
    return out, count[0]


def merge_lean_torch(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of the lean merge: ``a`` (the four value-key tensors)
    becomes lexmax(a, b) in place; returns the strict-win count of ``b`` as
    an int32 scalar tensor."""
    take_b = lex_gt(b, a)
    for fa, fb in zip(a, b):
        fa.copy_(torch.where(take_b, fb, fa))
    return take_b.sum(dtype=torch.int64).to(torch.int32)


def merge_lean(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """The lean merge in place into ``a`` (four value-key tensors of one
    shape): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. An elementwise select has no hazard, so the kernel writes into
    its first operand. Returns the strict-win count of ``b``."""
    if len(a) != len(LEAN_FIELDS) or len(b) != len(LEAN_FIELDS):
        raise ValueError("merge_lean takes the four value-key fields of each table")
    device = a[0].device
    if device.type == "cpu":
        return merge_lean_torch(a, b)
    _build.require_cuda(device, "merge_lean")
    _build.check_fields((*a, *b), a[0].shape, device, "merge_lean")
    lib = _build.library()
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.bt_merge(
            _build.pointers(a), _build.pointers(b), _build.pointers(a),
            count.data_ptr(), a[0].numel(), 0, len(LEAN_FIELDS), _build.stream_of(device),
        )
    _build.check(err, "merge_lean")
    _build.LAUNCHES["merge"] += 1
    return count[0]
