"""CPU models of the port's fused frontier kernels, step by step as the
CUDA kernels schedule their work, for the tests to hold against the
reference (the kernels themselves run only on the card):

- ``frontier_pipe_model``: ``frontier_pipe_kernel`` of
  ``bullet_tpu_torch/csrc/frontier.cuh``, the pipelined m-round pass of
  the compacting frontier step (#19, #16 and #8 at m = 8), with the
  order-preserving key encodings it holds values in (``PipeKey``), on
  ``pipe_pass_model``, the pass over whole columns;
- ``multiround_model``: ``packed_round.cu`` at m rounds (#11): m // 8 of
  the same passes over every stripe with a total count, then m % 8 single
  sweeps;
- ``shard_pipe_model``: ``shard_pipe_kernel`` of
  ``bullet_tpu_torch/csrc/frontier_shard.cu``, the same stages over one
  shard's extended column (#7 and #23 at m = 8);
- ``shard_sweep_model``: ``shard_sweep_kernel`` of the same file, the
  single round at m = 1 (#6 and #22): two boundary rows, a ring of rows
  prefetched in registers, units of adjacent columns;
- ``apply_model``: ``apply_packed.cu`` (#9 and #10), one op a thread in
  turn, the entry's planes read only as far as the compare needs;
- ``shard_window_model``: ``frontier_shard_window.cu`` (#25), the distance
  chain on shared-memory row tiles with carried halos and the atomic stats
  reduction;
- ``window_model``: ``window_packed.cu`` (#12 and #17), the window join of
  a block's columns in shared memory (both forms: a whole column wrapped or
  clipped, and the extended column between slabs with its center count),
  with ``window_cols``, the block width its host code picks.

Every model vectorises over columns (a column is a CUDA thread, or a lane
of a block, and columns never interact) and follows the kernel's order of
reads, stores and reductions."""

import torch

from bullet_tpu_torch.ops import packed as pk

# frontier_shard_window.cu's constants
WINDOW_COLS = 16
FLAG = 1 << 30
DIST_MASK = FLAG - 1
FILL = 1 << 24
# cudaDevAttrMaxSharedMemoryPerBlockOptin and
# cudaDevAttrMaxSharedMemoryPerMultiprocessor on an H100
H100_SMEM_OPTIN = 232448
H100_SMEM_PER_SM = 233472


MASK32 = 0xFFFFFFFF
BIAS = 0x80000000


def _u32(x):
    """int32 bits as their unsigned value (int64)."""
    return x.to(torch.int64) & MASK32


def _s32(x):
    """Unsigned values (int64) back to int32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


class PipeKey:
    """frontier.cuh's PipeKey<E> for a layout ("packed", "rank", "rank1",
    "reference" and "lww" for the 7 dense fields, "lean"): the words the
    pipelined pass holds an entry in, field by field as int64. A one-word
    key (rank, rank1) is the entry itself, compared signed. Longer keys are
    unsigned words, ``gt`` the borrow out of a - b over the key words
    (least significant first, as the subtract chain runs): the dense and
    lean key words biased by 2^31, the packed key (cls, khi, klo, vid),
    96 bits, repacked into three words with cls ^ 8 and khi, klo ^ 2^31."""

    ORDER = {"packed": (0, 1, 2), "reference": (0, 1, 2, 3, 4, 5),
             "lww": (5, 0, 1, 2, 3, 4), "lean": (0, 1, 2, 3)}

    def __init__(self, layout):
        self.layout = layout

    def encode(self, fields):
        if self.layout in ("rank", "rank1"):
            return [f.to(torch.int64) for f in fields]
        if self.layout == "packed":
            khi, klo, cv = map(_u32, fields)
            cls, hi, lo = (cv >> 28) ^ 8, khi ^ BIAS, klo ^ BIAS
            return [(cls << 28) | (hi >> 4), ((hi << 28) & MASK32) | (lo >> 4),
                    ((lo << 28) & MASK32) | (cv & 0x0FFFFFFF)]
        keyed = len(self.ORDER[self.layout])
        return [_u32(f) ^ (BIAS if i < keyed else 0) for i, f in enumerate(fields)]

    def decode(self, words):
        if self.layout in ("rank", "rank1"):
            return [w.to(torch.int32) for w in words]
        if self.layout == "packed":
            w0, w1, w2 = words
            hi = ((w0 << 4) & MASK32) | (w1 >> 28)
            lo = ((w1 << 4) & MASK32) | (w2 >> 28)
            return [_s32(hi ^ BIAS), _s32(lo ^ BIAS),
                    _s32((((w0 >> 28) ^ 8) << 28) | (w2 & 0x0FFFFFFF))]
        keyed = len(self.ORDER[self.layout])
        return [_s32(w ^ (BIAS if i < keyed else 0)) for i, w in enumerate(words)]

    def gt(self, b, a):
        if self.layout in ("rank", "rank1"):
            return b[0] > a[0]
        borrow = torch.zeros_like(a[0])
        for i in reversed(self.ORDER[self.layout]):
            borrow = (a[i] - b[i] - borrow < 0).to(torch.int64)
        return borrow.bool()


def pipe_pass_model(table, wrap, key, depth):
    """One pipelined pass of ``depth`` rounds over whole columns, as
    ``frontier_pipe_kernel`` of frontier.cuh runs it, in place on
    ``table`` ([p, cols] tensors): per column, step e of the extended
    sequence (p + 2 depth rows, real row (e - depth) mod p) reads input e
    in ``key``'s encoding (a ring's rows 0..depth - 1 from the encoded copy
    saved when first read, since the pass has overwritten them; a chain's
    encoded zero rows outside the central copy), stage k emits round k at
    row e - k from its two kept rows and stage k - 1's output, compared by
    ``key.gt``, only the central copy counts (a chain's rows outside it
    forced to zero), and stage depth's output is decoded and stored at real
    row e - 2 depth. Returns (each column's changed count, int64; each
    column's bit mask of the rounds that changed it). The kernel's rotation
    of each stage's history through three register slots moves the same
    values, and its steps in [2 depth, p + depth] skip the row tests, which
    hold there; the model keeps both plain."""
    p, cols = table[0].shape
    zero = key.encode([torch.zeros(cols, dtype=torch.int32) for _ in table])
    saved = {}

    def read(e):
        r = e - depth
        if not wrap:
            return key.encode([t[r] for t in table]) if 0 <= r < p else zero
        if r >= p:
            return saved[r % p]
        row = key.encode([t[r % p] for t in table])
        if 0 <= r < depth:
            saved[r] = row
        return row

    up = [zero] * depth
    cur = [zero] * depth
    total = torch.zeros(cols, dtype=torch.int64)
    rounds = torch.zeros(cols, dtype=torch.int64)
    length = p + 2 * depth
    nxt = read(0)
    for e in range(length):
        inp = nxt
        if e + 1 < length:
            nxt = read(e + 1)
        for k in range(depth):
            row = e - k - 1
            g1 = key.gt(up[k], cur[k])
            v = [torch.where(g1, a, b) for a, b in zip(up[k], cur[k])]
            g2 = key.gt(inp, v)
            v = [torch.where(g2, a, b) for a, b in zip(inp, v)]
            if depth <= row < p + depth:
                c = g1.to(torch.int64) + g2.to(torch.int64)
                total += c
                rounds |= (c > 0).to(torch.int64) << k
            elif not wrap:
                v = zero
            up[k], cur[k] = cur[k], inp
            inp = v
        if e >= 2 * depth:
            for t, x in zip(table, key.decode(inp)):
                t[e - 2 * depth] = x
    return total, rounds


def frontier_pipe_model(fields, ids, tile, wrap, key, depth):
    """One compacting frontier step of ``depth`` rounds as the pipelined
    pass runs it (``pipe_pass_model`` on the columns of the stripes in
    ``ids``), in place on ``fields``. Returns the next ids array (the
    compaction of frontier.cuh: last == depth kept in ascending order, the
    count, the changed total wrapping like int32, the max last round)."""
    p, n = fields[0].shape
    t_total = n // tile
    count = int(ids[t_total])
    out = torch.zeros(t_total + (3 if depth > 1 else 2), dtype=torch.int32)
    if count == 0:
        return out
    stripes = ids[:count].to(torch.int64)
    cols = (stripes[:, None] * tile + torch.arange(tile)).reshape(-1)
    table = [f[:, cols].clone() for f in fields]
    total, rounds = pipe_pass_model(table, wrap, key, depth)
    for f, t in zip(fields, table):
        f[:, cols] = t
    changed = total.reshape(count, tile).sum(1)
    ored = torch.zeros(count, dtype=torch.int64)
    for k in range(depth):
        ored |= ((rounds.reshape(count, tile) >> k) & 1).amax(1) << k
    last = torch.tensor([int(x).bit_length() for x in ored])
    keep = stripes[last == depth]
    out[: keep.numel()] = keep.to(torch.int32)
    out[t_total] = keep.numel()
    out[t_total + 1] = pk._wrap_int32(int(changed.sum()))
    if depth > 1:
        out[t_total + 2] = int(last.max())
    return out


# frontier.cuh's kPipeDepth and kMaxTile
PIPE_DEPTH = 8
MAX_TILE = 256


def multiround_model(fields, wrap, m, key, count=0):
    """``ring_multiround_packed`` as packed_round.cu schedules m rounds on
    the card, in place on ``fields`` ([p, n]): m // 8 pipelined passes
    (``frontier_pipe_kernel`` with its total count, one block a stripe of
    256 columns, the ragged last one's columns past n taking no part), then
    m % 8 single sweeps (bt::sweep_column, the plain round). Every block's
    sum lands in the count with an unsigned atomicAdd; ``count`` is its
    value before the call (the wrapper zeroes it). Returns the count as
    int32, wrapped mod 2^32."""
    n = fields[0].shape[1]
    count &= MASK32
    for _ in range(m // PIPE_DEPTH):
        for c0 in range(0, n, MAX_TILE):
            table = [f[:, c0:c0 + MAX_TILE].clone() for f in fields]
            total, _ = pipe_pass_model(table, wrap, key, PIPE_DEPTH)
            for f, t in zip(fields, table):
                f[:, c0:c0 + MAX_TILE] = t
            count = (count + int(total.sum())) & MASK32
    if m % PIPE_DEPTH:
        _, c = pk.packed_round_torch(fields, wrap, m % PIPE_DEPTH)
        count = (count + int(c)) & MASK32
    return pk._wrap_int32(count)


def shard_pipe_model(fields, tops, bottoms, ids, tile, key, depth):
    """One per-shard frontier step of ``depth`` rounds as the pipelined pass
    of frontier_shard.cu runs it, in place on the shard's ``fields``
    ([b, n]) given its [s, n] boundary rows ``tops`` and ``bottoms``, which
    it only reads. Per column, step e of the pass reads input e, extended
    row s - depth + e (the extended column: ``tops``, the shard, then
    ``bottoms``), in ``key``'s encoding; the stages start from encoded
    zeros; stage k emits round k at pass row e - k from its two kept rows
    and stage k - 1's output, compared by ``key.gt``; only the shard's pass
    rows [depth, depth + b) count, and stage depth's output is decoded and
    stored at shard row e - 2 depth for every e >= 2 depth. The pass is
    b + 2 depth steps long. As in the kernel, the steps in [2 depth,
    b + depth] (the body) count every stage, read the next input and store
    with no test at all; the head and the tail test. Returns the per-round,
    per-stripe counts, int32 [depth, t_total] (each a sum wrapping like
    uint32), zero for stripes not in ids."""
    b, n = fields[0].shape
    s = tops[0].shape[0]
    t_total = n // tile
    counts = torch.zeros((depth, t_total), dtype=torch.int32)
    count = int(ids[t_total])
    if count == 0:
        return counts
    stripes = ids[:count].to(torch.int64)
    cols = (stripes[:, None] * tile + torch.arange(tile)).reshape(-1)

    def read(e):  # ExtColumn::load of extended row s - depth + e
        r = s - depth + e
        src, i = (tops, r) if r < s else (fields, r - s) if r < s + b else (bottoms, r - s - b)
        return key.encode([f[i, cols] for f in src])

    zero = key.encode([torch.zeros(cols.numel(), dtype=torch.int32) for _ in fields])
    up = [zero] * depth
    cur = [zero] * depth
    cnt = torch.zeros((depth, cols.numel()), dtype=torch.int64)
    length, head = b + 2 * depth, 2 * depth
    body = max(head, b + depth + 1)
    nxt = read(0)
    for e in range(length):
        edge = not head <= e < body
        inp = nxt
        if not edge or e + 1 < length:
            nxt = read(e + 1)
        for k in range(depth):
            g1 = key.gt(up[k], cur[k])
            v = [torch.where(g1, a, c) for a, c in zip(up[k], cur[k])]
            g2 = key.gt(inp, v)
            v = [torch.where(g2, a, c) for a, c in zip(inp, v)]
            if not edge or depth <= e - k - 1 < depth + b:
                cnt[k] += g1.to(torch.int64) + g2.to(torch.int64)
            up[k], cur[k] = cur[k], inp
            inp = v
        if e >= head:
            for f, x in zip(fields, key.decode(inp)):
                f[e - 2 * depth, cols] = x
    per_stripe = cnt.reshape(depth, count, tile).sum(2) & MASK32
    counts[:, stripes] = _s32(per_stripe)
    return counts


# frontier_shard.cu's m = 1 kernel: the rows of a thread's ring
SWEEP_RING = 6
# the key fields of each layout, most significant first, as lexmax.cuh's
# E::gt compares them (signed); the packed layout's are (cv >> 28, khi,
# klo, cv)
ENTRY_KEYS = {"reference": (0, 1, 2, 3, 4, 5), "lww": (5, 0, 1, 2, 3, 4),
              "lean": (0, 1, 2, 3), "rank": (0,), "rank1": (0,)}


def entry_gt(layout, b, a):
    """lexmax.cuh's E::gt: ``b`` strictly beats ``a``, field lists of a
    layout compared as signed int32 key words, most significant first."""
    def keys(v):
        if layout == "packed":
            return [v[2] >> 28, v[0], v[1], v[2]]
        return [v[i] for i in ENTRY_KEYS[layout]]

    gt = torch.zeros(a[0].shape, dtype=torch.bool)
    eq = torch.ones_like(gt)
    for x, y in zip(keys(b), keys(a)):
        gt |= eq & (x > y)
        eq &= x == y
    return gt


def sweep_unit(nf, tile):
    """The columns a thread of shard_sweep_kernel takes (on rows aligned for
    its accesses): the widest of 4, 2 and 1 up to its field count's width
    (1 at nf = 7, 2 at nf = 4 and 3, 4 at nf = 2 and 1) whose units fill
    the stripe's tile columns in whole warps."""
    width = 1 if nf >= 7 else 2 if nf >= 3 else 4
    return next(v for v in (4, 2, 1) if v <= width and tile % (32 * v) == 0)


def shard_sweep_model(fields, tops, bottoms, ids, tile, layout, ring=SWEEP_RING):
    """One per-shard frontier round (m = 1) as shard_sweep_kernel of
    frontier_shard.cu runs it, in place on the shard's ``fields`` ([b, n])
    given its [s, n] boundary rows, which it only reads. Block j takes
    stripe ids[j], each thread a unit of ``sweep_unit(nf, tile)`` adjacent
    columns. A thread's inputs are x[0] = tops row s - 1, x[1 + i] = shard
    row i, x[b + 1] = bottoms row 0, each read once; slot i mod ``ring`` of
    its ring holds x[i]. It loads x[0], ..., x[ring - 1], then for each row
    r joins slots r, r + 1, r + 2 (cur, then up, then down, by ``entry_gt``
    of ``layout``), stores row r and loads x[r + ring] into slot r, whose
    x[r] it no longer needs. Loads read the live tensors, so a load the
    schedule put after the store of its row would read the new value; a
    slot read before it holds the expected input fails an assertion. Each
    thread sums its unit's wins, each block its threads' mod 2^32. Returns
    the counts, int32 [1, t_total], zero for stripes not in ids."""
    b, n = fields[0].shape
    s = tops[0].shape[0]
    t_total = n // tile
    counts = torch.zeros((1, t_total), dtype=torch.int32)
    count = int(ids[t_total])
    if count == 0:
        return counts
    unit = sweep_unit(len(fields), tile)
    stripes = ids[:count].to(torch.int64)
    # thread t of block j owns columns stripes[j] tile + t unit + [0, unit)
    cols = (stripes[:, None] * tile + torch.arange(tile)).reshape(-1)
    loads = []

    def load(i):
        src, row = ((tops, s - 1) if i == 0 else (fields, i - 1) if i <= b
                    else (bottoms, 0) if i == b + 1 else (None, None))
        if src is None:
            return None
        loads.append(i)
        return i, [f[row, cols].clone() for f in src]

    slots = [load(i) for i in range(ring)]
    wins = torch.zeros(cols.numel(), dtype=torch.int64)
    for r in range(b):
        held = [slots[(r + d) % ring] for d in range(3)]
        assert [x[0] for x in held] == [r, r + 1, r + 2], "a slot lost its row"
        up, cur, down = (x[1] for x in held)
        g1 = entry_gt(layout, up, cur)
        best = [torch.where(g1, u, c) for u, c in zip(up, cur)]
        g2 = entry_gt(layout, down, best)
        best = [torch.where(g2, d, c) for d, c in zip(down, best)]
        wins += g1.to(torch.int64) + g2.to(torch.int64)
        for f, v in zip(fields, best):
            f[r, cols] = v
        slots[r % ring] = load(r + ring)
    assert loads == list(range(b + 2)), "every input read once, in order"
    per_thread = wins.reshape(count, tile // unit, unit).sum(2)
    counts[0, stripes] = _s32(per_thread.sum(1) & MASK32)
    return counts


# apply_packed.cu's launch: threads a block, and at most this many blocks an
# SM (the grid strides over the ops past that); an H100's SMs
APPLY_THREADS, APPLY_BLOCKS_PER_SM, H100_SMS = 256, 16, 132


def apply_model(table, ops, layout, sms=H100_SMS):
    """bt_apply_packed as apply_packed_kernel runs it, in place on
    ``table`` (nf [p, n] fields of ``layout``): ``ops`` [2 + nf, K] with
    unique (peer, slot) pairs. The grid is min(ceil(K / T), 16 ``sms``)
    blocks of T = 256 threads; thread t of block j takes ops j T + t + r G T
    (r = 0, 1, ...; G blocks), one at a time, in turn. An op outside [0, p)
    x [0, n) or dead (E::present false) reads no entry; a live one reads
    its entry's planes most significant key first, only as far as the
    compare needs (packed: cv, then khi on a class tie, then klo on a khi
    tie; rank and rank1: the rank alone), and stores every field if it
    strictly beats the entry. Each turn r of every thread runs before the
    next (one order the card may take; the unique pairs make every order
    give the same table), blocks last first within a turn; each block adds
    its wins, summed mod 2^32, to the count. Returns (the count as int32,
    the entries read of each plane)."""
    p, n = table[0].shape
    k = ops.shape[1]
    planes = [f.view(-1) for f in table]
    blocks = min(-(-k // APPLY_THREADS), APPLY_BLOCKS_PER_SM * sms)
    stride = blocks * APPLY_THREADS
    wins = [0] * blocks
    reads = [0] * len(planes)
    for first in range(0, k, stride):
        for j in reversed(range(blocks)):
            if first + j * APPLY_THREADS >= k:
                continue
            i = torch.arange(first + j * APPLY_THREADS,
                             min(first + (j + 1) * APPLY_THREADS, k))
            peer, slot = ops[0, i].to(torch.int64), ops[1, i].to(torch.int64)
            op = [v[i] for v in ops[2:]]
            live = (peer >= 0) & (peer < p) & (slot >= 0) & (slot < n)
            live &= (op[0] > 0) if layout == "rank1" else (op[-1] >> 28) > 0
            idx = (peer * n + slot).clamp(0, p * n - 1)
            order = (2, 0, 1) if layout == "packed" else (0,)
            decided = ~live
            beats = torch.zeros_like(live)
            for f in order:  # the planes in the compare's order, while undecided
                need = ~decided
                reads[f] += int(need.sum())
                cur = torch.where(need, planes[f][idx], 0)
                a, b = (op[f] >> 28, cur >> 28) if (layout, f) == ("packed", 2) else (op[f], cur)
                beats |= need & (a > b)
                decided |= need & (a != b)
            if layout == "packed":  # the class and both keys tie: the whole cv
                need = ~decided
                beats |= need & (op[2] > torch.where(need, planes[2][idx], 0))
            for pl, v in zip(planes, op):
                pl[idx[beats]] = v[beats]
            wins[j] += int(beats.sum())
    total = 0
    for j in reversed(range(blocks)):
        total = (total + (wins[j] & MASK32)) & MASK32
    return _s32(torch.tensor(total)), reads


def window_tile_rows(nf, b, m, optin=H100_SMEM_OPTIN):
    """The row tile h_max that frontier_shard_window.cu's host code picks:
    the whole extended column when two (nf + 1)-plane buffers of it fit the
    shared memory (less 1 KB for the block reductions), else as many rows
    as fit beside the 2 m-row carry."""
    budget = optin - 1024
    length = b + 2 * m
    row_bytes = 2 * (nf + 1) * WINDOW_COLS * 4
    h_max = min(length, budget // row_bytes)
    if h_max < length:
        h_max = (budget - nf * 2 * m * WINDOW_COLS * 4) // row_bytes
    return h_max


def _window_join(vals, word, shift, s):
    """One join of the kernel's chain on a tile: row r takes the candidate
    at r - shift (the all-zero entry at distance FILL when shifted out): a
    strict win its values and distance + s with the changed flag, equal
    keys the smaller distance."""
    cand = [pk._shift_line(v, shift, 0) for v in vals]
    cand_d = pk._shift_line(word & DIST_MASK, shift, FILL - s) + s
    gt = pk.packed_beats(cand, vals)
    eq = pk._keys_eq(pk.table_keys(cand), pk.table_keys(vals))
    kept = torch.where(eq, torch.minimum(word & DIST_MASK, cand_d) | (word & FLAG), word)
    return ([torch.where(gt, c, v) for c, v in zip(cand, vals)],
            torch.where(gt, cand_d | FLAG, kept))


def shard_window_model(fields, tops, bottoms, ids, tile, m, h_max, order=None,
                       carry_halos=True):
    """One per-shard window step as frontier_shard_window.cu runs it, in
    place on ``fields``: blocks of WINDOW_COLS columns of the active
    stripes, each walking row tiles of at most ``h_max`` extended rows.
    A tile loads the rows past its carry from the live tensors (so a row
    an earlier tile wrote would be read wrong: the carry must prevent
    that), copies the pre-call values of its last 2 m rows to the carry
    when another tile follows, runs the chain's joins, writes its h rows
    between the m-row margins back and folds their changed flags and
    distances. Each block's sum and max go into the zeroed stats with an
    add and a max, in the block order ``order`` (a permutation of the
    blocks; reversed by default). ``carry_halos=False`` loads every tile
    whole from the live tensors instead: the race the carry prevents.
    Returns the [2, t_total] stats."""
    b, n = fields[0].shape
    t_total = n // tile
    stats = torch.zeros((2, t_total), dtype=torch.int32)
    count = int(ids[t_total])
    if count == 0:
        return stats
    length = b + 2 * m
    inner = h_max - 2 * m
    assert inner >= 1, "a tile must hold more than its two margins"
    stripes = ids[:count].to(torch.int64)
    cols = (stripes[:, None] * tile + torch.arange(tile)).reshape(-1)

    def load(x0, x1):
        parts = []
        for seg, lo, hi in ((tops, 0, m), (fields, m, m + b), (bottoms, m + b, length)):
            a, z = max(x0, lo), min(x1, hi)
            if a < z:
                parts.append([f[a - lo:z - lo][:, cols] for f in seg])
        return [torch.cat([p[i] for p in parts]) for i in range(len(fields))]

    changed = torch.zeros(cols.numel(), dtype=torch.int64)
    last = torch.zeros(cols.numel(), dtype=torch.int64)
    carry = None
    base = 0
    while base < b:
        rows = min(h_max, length - base)
        kept = 2 * m if base > 0 and carry_halos else 0
        fresh = load(base + kept, base + rows)
        vals = [torch.cat([c, f]) for c, f in zip(carry, fresh)] if kept else fresh
        word = torch.zeros_like(vals[0])
        carry = [v[inner:inner + 2 * m].clone() for v in vals] if base + inner < b else None
        reach = 0
        while reach < m:
            s = min(m - reach, reach + 1)
            for shift in (s, -s):
                vals, word = _window_join(vals, word, shift, s)
            reach += s
        h = min(inner, b - base)
        for f, v in zip(fields, vals):
            f[base:base + h, cols] = v[m:m + h]
        w = word[m:m + h].to(torch.int64)
        flag = (w & FLAG) != 0
        changed += flag.sum(0)
        last = torch.maximum(last, torch.where(flag, w & DIST_MASK, 0).amax(0))
        base += inner
    blocks = cols.numel() // WINDOW_COLS
    per_block = (changed.reshape(blocks, WINDOW_COLS).sum(1),
                 last.reshape(blocks, WINDOW_COLS).amax(1))
    stripe_of = stripes.repeat_interleave(tile // WINDOW_COLS)
    for j in (order if order is not None else range(blocks - 1, -1, -1)):
        s = int(stripe_of[j])
        stats[0, s] += int(per_block[0][j])
        stats[1, s] = max(int(stats[1, s]), int(per_block[1][j]))
    return stats


# window_packed.cu's constants: the widest block (2^4 columns), a block's
# static and system shared memory, and the flags of its extended column
WINDOW_LOG_MAX_COLS = 4
WINDOW_RESERVED = 1024
WINDOW_SYSTEM = 1024
WRAP, CLIP_TOP, CLIP_BOTTOM = 1, 2, 4
LAYOUT_OF_NF = {3: "packed", 2: "rank", 1: "rank1"}


def window_rows(nf, optin=H100_SMEM_OPTIN):
    """bt_window_rows: the most extended rows one launch takes."""
    return (optin - WINDOW_RESERVED) // (2 * nf * 4)


def window_cols(nf, length, optin=H100_SMEM_OPTIN, per_sm=H100_SMEM_PER_SM):
    """window_packed.cu's pick_cols: a block of 16 or 8 columns (whole
    sectors a row) first, two blocks an SM before one; 4, 2 or 1 only when
    a block of 8 does not fit; None when one column does not fit."""
    for widest, least in ((WINDOW_LOG_MAX_COLS, 3), (2, 0)):
        for two in (True, False):
            for lc in range(widest, least - 1, -1):
                nbytes = 2 * nf * length * 4 << lc
                fits = (2 * (nbytes + WINDOW_RESERVED + WINDOW_SYSTEM) <= per_sm if two
                        else nbytes + WINDOW_RESERVED <= optin)
                if fits:
                    return 1 << lc
    return None


def window_model(fields, tops, bottoms, m, flags, cols=None):
    """One launch of window_kernel, in place on the center rows ``fields``
    [h, n]: ``tops`` / ``bottoms`` the slab rows around them (None for
    none), ``flags`` WRAP (a whole ring column), CLIP_TOP / CLIP_BOTTOM (a
    chain's edge on a side without a slab). Blocks of ``cols`` columns
    (``window_cols`` by default; the ragged last block's missing columns
    load as zeros and are neither written nor counted) load the extended
    column [tops | fields | bottoms] into a plane, encode it (PipeKey),
    join it to radius min(m - 1, len) by the reference's doubling steps,
    each a 3-way join of a row with the rows s up and s down of the
    previous plane (wrapped, clamped to the edge row, or the encoded
    all-zero entry past an end), then run the classic round on the center
    rows with the all-zero entry past an unwrapped end, counting each win.
    Each block's count is summed mod 2^32 and added to the total. (The
    kernel's threads take 4 adjacent columns at a time; columns are
    independent, so the model computes all of a block's at once.) Returns
    the count as int32."""
    key = PipeKey(LAYOUT_OF_NF[len(fields)])
    h, n = fields[0].shape
    ht = tops[0].shape[0] if tops is not None else 0
    hb = bottoms[0].shape[0] if bottoms is not None else 0
    length = ht + h + hb
    cols = cols or window_cols(len(fields), length)
    assert cols is not None, "one column does not fit a block"
    blocks = -(-n // cols)
    width = blocks * cols
    wrap, clip_top, clip_bottom = flags & WRAP, flags & CLIP_TOP, flags & CLIP_BOTTOM
    parts = [p for p in (tops, fields, bottoms) if p is not None]
    ext = [torch.zeros((length, width), dtype=torch.int32) for _ in fields]
    for e, f in zip(ext, zip(*parts)):
        e[:, :n] = torch.cat(f)
    plane = key.encode(ext)
    zero = key.encode([torch.zeros((), dtype=torch.int32) for _ in fields])
    x = torch.arange(length)

    def shifted(vals, rows, outside):
        """Row x of the result is row rows[x] of vals (the zero entry where
        ``outside``)."""
        safe = rows.clamp(0, length - 1)
        return [torch.where(outside[:, None], z, v[safe]) for v, z in zip(vals, zero)]

    radius = min(m - 1, length)
    r = 0
    while r < radius:
        s = min(radius - r, 2 * r + 1)
        up, down = x - s, x + s
        if wrap:
            up, down = (x - s % length) % length, (x + s % length) % length
        else:
            if clip_top:
                up = up.clamp(min=0)
            if clip_bottom:
                down = down.clamp(max=length - 1)
        best = plane
        for rows in (up, down):
            cand = shifted(plane, rows, (rows < 0) | (rows >= length))
            gt = key.gt(cand, best)
            best = [torch.where(gt, c, b) for c, b in zip(cand, best)]
        plane = best
        r += s
    center = torch.arange(ht, ht + h)
    up, down = center - 1, center + 1
    if wrap:
        up, down = up % length, down % length
    cur = [v[center] for v in plane]
    out = cur
    changed = torch.zeros((h, width), dtype=torch.int64)
    for rows in (up, down):
        cand = shifted(plane, rows, (rows < 0) | (rows >= length))
        gt = key.gt(cand, out)
        changed += gt
        out = [torch.where(gt, c, o) for c, o in zip(cand, out)]
    for f, o in zip(fields, key.decode(out)):
        f[:] = o[:, :n]
    live = (torch.arange(width) < n).to(torch.int64)
    per_block = ((changed * live).sum(0).reshape(blocks, cols).sum(1)) & MASK32
    return _s32(per_block.sum() & MASK32)


def window_model_launch(cols=None):
    """A ``launch`` for ops/packed.py's ``window_row_tiles`` running
    ``window_model`` (the kernel's extended form, clip 1 / 2 for a chain's
    top / bottom edge as the C entry takes it)."""
    def launch(fields, tops, bottoms, m, clip):
        return window_model(fields, tops, bottoms, m, clip << 1, cols).reshape(1)
    return launch
