# coding: utf-8
"""The SpMM kernels' schedule (``ctgcn_torch.ops.bsr_spmm``): what the host
builds once per plan, and numpy emulations of both CUDA kernels that follow
it, pieces summed in the kernels' order.

The CUDA kernels run only on a GPU; here each kernel's schedule is walked
in numpy as ``csrc/bsr_spmm.cu`` walks it (warps over chunks or CTA ranges,
G lane groups on consecutive nonzeros with per-row segmented sums over the
groups, carries, pieces, the second pass or the CTA's combine, the zero
fill; and the register kernels: a warp a row, and the first pass in chunks
of 128), on the pyramid, delta pyramid, transposed, padded, empty and
hub-row plans, each in both of the row walk's modes, and held against the
plain CSR version and the JAX package's Pallas kernels in interpret mode.  Tolerance: 1e-5 relative to each output and to its
largest magnitude, for f32 sums taken in another order than the plain
version's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.ops import bsr_spmm as T
from ctgcn_tpu.ops import pallas_spmm as J

RTOL = 1e-5
#: lane groups a warp: 1 (d >= 68 f32), and 4 and 32 (d = 64 .. 4)
GROUPS = (1, 4, 32)


def _rand(rng, n_rows, n_cols, density):
    dense = (rng.random((n_rows, n_cols)) < density) * rng.random(
        (n_rows, n_cols))
    return sp.csr_matrix(dense.astype(np.float32))


def _hub(rng):
    """Rows of 700 and 90 nonzeros among short and empty rows."""
    m = sp.lil_matrix((400, 900), dtype=np.float32)
    m[3, rng.choice(900, 700, replace=False)] = rng.random(700) + 0.1
    m[200, rng.choice(900, 90, replace=False)] = rng.random(90) + 0.1
    for r in rng.choice(400, 80, replace=False):
        m[r, rng.choice(900, rng.integers(1, 6), replace=False)] = 1.0
    return m.tocsr()


def _nested(rng, n, k, cores=None):
    """k nested slots of a random graph: slot i keeps the edges among the
    nodes of degree at least its core (``cores``, or the k largest
    degrees)."""
    base = (rng.random((n, n)) < 0.08) * rng.random((n, n))
    base = np.triu(base, 1) + np.triu(base, 1).T
    deg = (base != 0).sum(1)
    cores = sorted(np.unique(deg))[-k:][::-1] if cores is None else cores
    return [sp.csr_matrix(base * np.outer(deg >= c, deg >= c))
            for c in cores]


def _delta(mats, n):
    """The slots' differences stacked (slot k holds A_k - A_{k+1}), each
    row grouped with its node's: the delta plans' layout, whose slot rows
    share no column."""
    slots = [mats[k] - mats[k + 1] for k in range(len(mats) - 1)] + mats[-1:]
    stacked = sp.vstack(slots).tocsr()
    stacked.eliminate_zeros()
    return T.build_csr_plan(stacked, row_group=np.arange(stacked.shape[0])
                            % n)


def _plans():
    rng = np.random.default_rng(0)
    mats = _nested(rng, 150, 3)
    fwd, tr = T.build_pyramid_plans([(0, mats[0]), (2, mats[2])], 150, 4)
    hub = _hub(rng)
    padded = T.build_block_plan(_rand(rng, 300, 260, 0.05))
    big = _nested(rng, 300, 4, cores=(0, 22, 25, 28))
    return {"pyramid": fwd, "pyramid_t": tr,
            "pyramid_big": T.build_pyramid_plans(list(enumerate(big)), 300,
                                                 4)[0],
            "delta": _delta(big, 300),
            "padded": T.pad_block_plan(padded, padded.num_blocks + 7),
            "empty": T.build_block_plan(sp.csr_matrix((64, 64))),
            "hub": T.build_csr_plan(hub), "hub_t": T.build_csr_plan(hub.T)}


PLANS = _plans()
CASES = sorted(PLANS)


def _np(plan):
    a = {k: getattr(plan, k).numpy().astype(np.int64) for k in (
        "csr_ptr", "csr_row", "csr_col", "row_order", "empty_runs",
        "cross_rows", "walk_nz", "walk_warp")}
    runs = a["empty_runs"].reshape(-1, 2)
    a["empty_rows"] = np.concatenate(
        [np.arange(r, r + n) for r, n in runs] or [np.zeros(0, int)])
    return a


def _groups(plan):
    """Each row's walk group: its node in a pyramid's stacked rows (the
    row's index modulo n_cols, as the plan functions group them), else
    itself."""
    rows = np.arange(plan.n_rows)
    return rows % plan.n_cols if plan.n_rows > plan.n_cols else rows


def _forced(plan, rows):
    """``plan`` with the row walk's schedule of the other mode, if asked:
    a warp a row (``rows``) or the ring's CTA ranges."""
    if plan.walk_rows == rows or plan.nnz == 0:
        return plan
    return T.with_row_order(plan, plan.row_order.numpy(), _groups(plan),
                            walk_rows=rows)


# ---------------------------------------------------------------------------
# what the host builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nnz, chunk", [(0, 16), (32_508, 16), (67_583, 16),
                                        (67_584, 32), (135_167, 32),
                                        (195_703, 128), (10 ** 7, 128)])
def test_chunk_from_nnz(nnz, chunk):
    """The chunk fills the card where nnz allows it (AS's transpose, 32,508
    nonzeros: 2,032 chunks where a fixed 128 gave 254), between the
    bounds, a power of two; from REGS_NNZ (UCI's 195,703) the register
    pass's CHUNK_MAX."""
    assert T.blockpar_chunk(nnz) == chunk
    if T.CHUNK_MIN < chunk < T.CHUNK_MAX:
        assert -(-nnz // chunk) >= T.CHUNK_WARPS
    assert (nnz >= T.REGS_NNZ) == (chunk == T.CHUNK_MAX)


@pytest.mark.parametrize("nnz", [T.REGS_NNZ - 1, T.REGS_NNZ])
def test_chunk_regs_from_nnz(nnz):
    """A plan gathers into registers in its first pass from REGS_NNZ
    nonzeros on, in chunks of CHUNK_MAX, with its crossing rows for that
    chunk."""
    rows = np.arange(nnz) % 4096
    cols = (np.arange(nnz) * 7919) % 40_000
    plan = T.build_csr_plan(sp.csr_matrix(
        (np.ones(nnz, np.float32), (rows, cols)), shape=(4096, 40_000)))
    assert plan.nnz == nnz
    assert plan.chunk_regs == (nnz >= T.REGS_NNZ)
    assert plan.chunk == T.blockpar_chunk(nnz)
    np.testing.assert_array_equal(
        plan.cross_rows.numpy(),
        T.cross_rows(plan.csr_ptr.numpy(), plan.chunk))


def _short(n_rows, row):
    """n_rows - 1 rows of one nonzero, and one of ``row``."""
    m = sp.lil_matrix((n_rows, n_rows + row), dtype=np.float32)
    m.setdiag(1.0)
    m[0, n_rows + 1:n_rows + row] = 2.0
    return T.build_csr_plan(m.tocsr())


@pytest.mark.parametrize("what, walk_rows", [
    ("nested", True), ("delta", False), ("short_small", True),
    ("long_small", False), ("short_large", False)])
def test_walk_rows_rule(what, walk_rows):
    """A warp a row where the walk groups' rows share their columns (a
    nested pyramid; not its deltas), or where every row takes one round of
    gathers (at most ROW_LOADS nonzeros) and the ring walk would leave SMs
    without a CTA; else the ring's CTA ranges."""
    ring_nnz = T.WALK_WARPS * T.SMS * T.CHUNK_MIN
    plan = {"nested": lambda: PLANS["pyramid_big"],
            "delta": lambda: PLANS["delta"],
            "short_small": lambda: _short(500, T.ROW_LOADS),
            "long_small": lambda: _short(500, T.ROW_LOADS + 1),
            "short_large": lambda: _short(ring_nnz + 64, 1)}[what]()
    assert plan.walk_rows == walk_rows
    if what in ("nested", "delta"):
        assert plan.max_row_nnz > T.ROW_LOADS


@pytest.mark.parametrize("case", CASES)
def test_blockpar_schedule_covers_each_row_once(case):
    """The chunks cover every nonzero once; every output row is written
    exactly once: by pass 1 (a row inside one chunk), pass 2 (the
    crossing rows, ascending) or the zero fill (the empty rows, as runs of
    at most FILL_RUN rows)."""
    plan = PLANS[case]
    a = _np(plan)
    ptr, chunk = a["csr_ptr"], plan.chunk
    assert chunk == T.blockpar_chunk(plan.nnz)
    starts = np.arange(0, plan.nnz, chunk)
    covered = np.concatenate([np.arange(s, min(plan.nnz, s + chunk))
                              for s in starts] or [np.zeros(0, int)])
    np.testing.assert_array_equal(covered, np.arange(plan.nnz))
    counts = np.diff(ptr)
    np.testing.assert_array_equal(a["empty_rows"], np.flatnonzero(counts == 0))
    assert np.all(a["empty_runs"].reshape(-1, 2)[:, 1] <= T.FILL_RUN)
    cross = a["cross_rows"].reshape(-1, 3)
    assert np.all(np.diff(cross[:, 0]) > 0)
    k0 = ptr[cross[:, 0]] // chunk
    np.testing.assert_array_equal(cross[:, 2], (ptr[cross[:, 0] + 1] - 1)
                                  // chunk)
    np.testing.assert_array_equal(cross[:, 1] // 2, k0)
    inside = np.setdiff1d(np.flatnonzero(counts), cross[:, 0])
    assert np.all(ptr[inside] // chunk == (ptr[inside + 1] - 1) // chunk)
    writes = np.bincount(np.concatenate([inside, cross[:, 0],
                                         a["empty_rows"]]),
                         minlength=plan.n_rows)
    assert (writes == 1).all()


@pytest.mark.parametrize("case", CASES)
def test_rowwalk_bins_cover_each_row_once(case):
    """The walk stream holds every nonzero once: the rows of ``row_order``
    that have nonzeros, each whole and in column order; the empty rows are
    the rest; the warp ranges, WALK_WARPS to a CTA, cover the stream in
    order, a CTA's edges are row edges (a row stays in one CTA), and a
    split row's pieces cover its nonzeros once, in column order."""
    plan = PLANS[case]
    a = _np(plan)
    ptr, wn, bounds = a["csr_ptr"], a["walk_nz"], a["walk_warp"]
    assert (len(bounds) - 1) % T.WALK_WARPS == 0
    assert bounds[0] == 0 and bounds[-1] == plan.nnz
    assert np.all(np.diff(bounds) >= 0)
    cta = np.append(bounds[:-1:T.WALK_WARPS], plan.nnz)
    counts = np.diff(ptr)
    np.testing.assert_array_equal(np.sort(wn), np.arange(plan.nnz))
    rows = a["row_order"][counts[a["row_order"]] > 0]
    np.testing.assert_array_equal(
        wn, np.concatenate([np.arange(ptr[r], ptr[r + 1]) for r in rows]
                           or [np.zeros(0, int)]))
    np.testing.assert_array_equal(
        np.sort(np.concatenate([rows, a["empty_rows"]])),
        np.arange(plan.n_rows))
    stream_row = a["csr_row"][wn]
    edges = cta[1:-1]
    edges = edges[(edges > 0) & (edges < plan.nnz)]
    assert np.all(stream_row[edges - 1] != stream_row[edges])
    split = 0
    for lo, hi in zip(cta[:-1], cta[1:]):
        for r in np.unique(stream_row[lo:hi]):
            pos = lo + np.flatnonzero(stream_row[lo:hi] == r)
            warps = np.searchsorted(bounds, pos, "right") - 1
            pieces = [wn[pos[warps == k]] for k in np.unique(warps)]
            np.testing.assert_array_equal(np.concatenate(pieces),
                                          np.arange(ptr[r], ptr[r + 1]))
            split += len(pieces) > 1
    assert T.schedule_stats(plan)["split_rows"] == split


@pytest.mark.parametrize("case", CASES)
def test_row_warps_take_a_row_each(case):
    """With a warp a row, warp w's range is the w-th row of the walk
    stream, whole; the last CTA's spare warps are empty."""
    plan = _forced(PLANS[case], True)
    a = _np(plan)
    bounds = a["walk_warp"]
    assert (len(bounds) - 1) % T.WALK_WARPS == 0
    counts = np.diff(a["csr_ptr"])
    walked = a["row_order"][counts[a["row_order"]] > 0]
    lens = np.diff(bounds)
    np.testing.assert_array_equal(lens[:len(walked)], counts[walked])
    assert not lens[len(walked):].any()
    assert len(bounds) - 1 - len(walked) < T.WALK_WARPS
    starts = bounds[:len(walked)]
    np.testing.assert_array_equal(a["csr_row"][a["walk_nz"][starts]],
                                  walked)


def _even_split(bounds):
    """The CTA edges of warp ranges that split each CTA evenly."""
    w = T.WALK_WARPS
    cta = np.append(bounds[:-1:w], bounds[-1])
    per = -(-np.diff(cta) // w)
    np.testing.assert_array_equal(
        bounds[:-1].reshape(-1, w),
        np.minimum(cta[1:, None], cta[:-1, None]
                   + per[:, None] * np.arange(w)))
    return cta


@pytest.mark.parametrize("case", ["pyramid", "pyramid_big", "hub"])
def test_walk_ctas_follow_groups(case):
    """A CTA takes the walk stream up to the first group end at or past
    each multiple of WALK_WARPS chunks (the pyramid's forward: a node's
    slot rows stay in one CTA; without groups, a row end), and its warps
    split it evenly."""
    plan = _forced(PLANS[case], False)
    a = _np(plan)
    cta = _even_split(a["walk_warp"])
    row = a["csr_row"][a["walk_nz"]]
    group = row % plan.n_cols if case.startswith("pyramid") else row
    ends = np.flatnonzero(np.append(group[1:] != group[:-1], True)) + 1
    budget = T.WALK_WARPS * plan.chunk
    want = np.unique(ends[np.searchsorted(ends, np.arange(
        budget, plan.nnz, budget))])
    np.testing.assert_array_equal(cta[1:-1], want[want < plan.nnz])
    node = np.searchsorted(cta, np.arange(plan.nnz), "right") - 1
    for n in np.unique(group):
        assert len(np.unique(node[group == n])) == 1


def test_walk_ctas_cut_a_large_group_at_rows():
    """A group over twice the budget is cut at row ends too."""
    lens = np.array([5, 30, 30, 30, 30, 4, 2])
    ends = np.cumsum(lens)
    group_end = ends[[0, 4, 5, 6]]
    bounds = T._walk_warps(lens, group_end, 2)
    cta = _even_split(bounds)
    np.testing.assert_array_equal(cta, [0, 35, 65, 95, 125, 129, 131])


def test_with_row_order_rebuilds_the_walk():
    """A plan walked in row order keeps its CSR and chunk schedule; its
    walk stream is the CSR itself, in ranges of about WALK_WARPS chunks
    (each row its own group: no shared columns, so the ring's ranges)."""
    plan = PLANS["pyramid_big"]
    nat = T.with_row_order(plan, np.arange(plan.n_rows))
    np.testing.assert_array_equal(nat.row_order.numpy(),
                                  np.arange(plan.n_rows))
    np.testing.assert_array_equal(nat.walk_nz.numpy(), np.arange(plan.nnz))
    assert plan.walk_rows and not nat.walk_rows
    lens = np.diff(plan.csr_ptr.numpy())
    lens = lens[lens > 0]
    np.testing.assert_array_equal(
        nat.walk_warp.numpy(), T._walk_warps(lens, np.cumsum(lens),
                                             plan.chunk))
    for f in ("csr_ptr", "csr_col", "csr_val", "empty_runs", "cross_rows"):
        assert torch.equal(getattr(nat, f), getattr(plan, f))
    x = torch.randn(plan.n_cols, 8)
    np.testing.assert_allclose(_rowwalk(nat, x.numpy(), 4)[0],
                               T.bsr_spmm_csr_plain(plan, x).numpy(),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("d, bf16, want", [
    (4, False, (1, 32, 1, 1)), (64, False, (16, 2, 1, 1)),
    (68, False, (32, 1, 1, 1)), (128, False, (32, 1, 1, 1)),
    (500, False, (32, 1, 4, 1)), (512, False, (32, 1, 4, 1)),
    (640, False, (32, 1, 4, 2)), (8, True, (1, 32, 1, 1)),
    (128, True, (16, 2, 1, 1)), (504, True, (32, 1, 2, 1)),
    (1032, True, (32, 1, 2, 3))])
def test_lane_groups(d, bf16, want):
    """Lane groups split the warp where it would cover over twice d (d <=
    64 f32, <= 128 bf16); else a warp covers up to 512 columns."""
    assert T.lane_groups(d, bf16) == want


@pytest.mark.parametrize("d, bf16, want", [
    (4, False, (32, 1, 1, 1)), (128, False, (32, 1, 1, 1)),
    (132, False, (32, 1, 2, 1)), (500, False, (32, 1, 2, 2)),
    (512, False, (32, 1, 2, 2)), (640, False, (32, 1, 2, 3)),
    (256, True, (32, 1, 1, 1)), (504, True, (32, 1, 2, 1)),
    (1032, True, (32, 1, 2, 3))])
def test_lane_groups_by_row(d, bf16, want):
    """The register kernels' whole warp over up to 2 pieces a lane, grid-y
    slices beyond (a warp a row; the register first pass)."""
    assert T.lane_groups(d, bf16, by_row=True) == want


def _walk_cta(b, n_walk, head, n_ctas):
    """csrc/bsr_spmm.cu ``walk_cta``: (walk CTA index or -1, fill CTA index
    or -1) of CTA b of a launch of n_ctas."""
    if b < head:
        return b, -1
    m, n_fill, r = n_ctas - head, n_ctas - n_walk, b - head
    f0, f1 = r * n_fill // m, (r + 1) * n_fill // m
    return (head + r - f0, -1) if f1 == f0 else (-1, f0)


@pytest.mark.parametrize("n_walk, head, n_fill", [
    (1421, 1056, 600), (242, 242, 813), (0, 0, 5), (7, 7, 0), (900, 264, 1),
    (300, 264, 2000)])
def test_fill_ctas_follow_the_first_wave(n_walk, head, n_fill):
    """The launch's first ``head`` CTAs walk; after them every walk CTA and
    every fill CTA comes once, the fill CTAs spread evenly."""
    roles = [_walk_cta(b, n_walk, head, n_walk + n_fill)
             for b in range(n_walk + n_fill)]
    walks = [w for w, _ in roles if w >= 0]
    fills = [f for _, f in roles if f >= 0]
    assert walks == list(range(n_walk))
    assert fills == list(range(n_fill))
    assert [w for w, _ in roles[:head]] == list(range(head))
    if n_fill > 1 and n_walk > head:
        gaps = np.diff([b for b, (_, f) in enumerate(roles) if f >= 0])
        assert gaps.max() - gaps.min() <= 1


# ---------------------------------------------------------------------------
# the kernels' schedules in numpy
# ---------------------------------------------------------------------------

def _walk(rows, nzs, col, val, x, start, end, lo, hi, G):
    """One warp's walk of stream positions [start, end) of [lo, hi)
    (csrc/bsr_spmm.cu ``walk``): G groups on consecutive positions, their
    products summed per row by an inclusive segmented scan (offsets 1, 2,
    4, ...), the carry added to the first segment.  Returns the rows it
    stores, the first row's piece (or None), the last row's (row, sum,
    is a piece) and (first, last, cross_start, cross_end)."""
    first, last = rows[start], rows[end - 1]
    cross_start = start > lo and rows[start - 1] == first
    cross_end = end < hi and rows[end] == last
    zero = np.zeros(x.shape[1], np.float32)
    outs, hold, acc, cur = {}, None, None, -1

    def finish(row, v):
        nonlocal hold
        if row == first and cross_start:
            hold = v.copy()
        else:
            assert row not in outs
            outs[row] = v.copy()

    for base in range(start, end, 128):
        n = min(128, end - base)
        r_pad = rows[base + n - 1]
        for s in range(-(-n // G)):
            rs, vs = [], []
            for q in range(G):
                t = base + s * G + q
                if s * G + q < n:
                    j = nzs[t]
                    rs.append(rows[t])
                    vs.append(np.float32(val[j]) * x[col[j]])
                else:
                    rs.append(r_pad)
                    vs.append(zero)
            if G == 1:
                if rs[0] != cur:
                    if cur >= 0:
                        finish(cur, acc)
                    cur, acc = rs[0], vs[0]
                else:
                    acc = acc + vs[0]
                continue
            v, o = list(vs), 1
            while o < G:
                v = [v[q] + v[q - o] if q >= o and rs[q - o] == rs[q]
                     else v[q] for q in range(G)]
                o *= 2
            tail = [q == G - 1 or rs[q + 1] != rs[q] for q in range(G)]
            if rs[0] != cur:
                if cur >= 0:
                    finish(cur, acc)
            else:
                v = [v[q] + acc if rs[q] == cur else v[q] for q in range(G)]
            if rs[0] == first and rs[-1] != first and cross_start:
                finish(first, v[tail.index(True)])
            for q in range(G):
                if tail[q] and rs[q] != rs[-1] and not (
                        rs[q] == first and cross_start):
                    assert rs[q] not in outs
                    outs[rs[q]] = v[q]
            acc, cur = v[-1], rs[-1]
    piece = cross_end or (cur == first and cross_start)
    return outs, hold, (cur, acc, piece), (first, last, cross_start,
                                           cross_end)


def _store(out, writes, rows):
    for r, v in rows.items():
        out[r] = v
        writes[r] += 1


def _blockpar(plan, x, G, chunk=None, vals=None):
    """bsr_spmm_blockpar's schedule: pass 1 a warp a chunk (rows inside it
    to out, the pieces of rows across its edges to scratch slot 0 or 1),
    pass 2 over the crossing rows (pieces added in chunk order), the zero
    fill.  Returns out and how many times each row was written."""
    a = _np(plan)
    chunk = plan.chunk if chunk is None else chunk
    cross = (a["cross_rows"] if chunk == plan.chunk
             else T.cross_rows(a["csr_ptr"], chunk))
    val = (plan.csr_val if vals is None else vals).numpy()
    out = np.full((plan.n_rows, x.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.n_rows, int)
    scratch = {}
    for w in range(-(-plan.nnz // chunk)):
        start, end = w * chunk, min(plan.nnz, (w + 1) * chunk)
        outs, hold, (cur, acc, piece), (first, *_) = _walk(
            a["csr_row"], np.arange(plan.nnz), a["csr_col"], val, x, start,
            end, 0, plan.nnz, G)
        _store(out, writes, outs)
        if hold is not None:
            scratch[2 * w] = hold
        if piece:
            scratch[2 * w + (cur != first)] = acc
        else:
            _store(out, writes, {cur: acc})
    for r, s0, k1 in cross.reshape(-1, 3):
        acc = scratch[s0]
        for k in range(s0 // 2 + 1, k1 + 1):
            acc = acc + scratch[2 * k]
        _store(out, writes, {r: acc})
    _store(out, writes, {r: 0.0 for r in a["empty_rows"]})
    return out, writes


def _rowwalk(plan, x, G, vals=None):
    """bsr_spmm_rowwalk's schedule: a CTA WALK_WARPS warp ranges of the
    walk stream; each row that begins in a warp and continues into the
    next added from the warps' pieces in warp order; the zero fill.
    Returns out and how many times each row was written."""
    a = _np(plan)
    val = (plan.csr_val if vals is None else vals).numpy()
    rows = a["csr_row"][a["walk_nz"]]
    out = np.full((plan.n_rows, x.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.n_rows, int)
    bounds = a["walk_warp"]
    for b in range(0, len(bounds) - 1, T.WALK_WARPS):
        lo, hi = bounds[b], bounds[b + T.WALK_WARPS]
        warps = []
        for k in range(T.WALK_WARPS):
            start, end = bounds[b + k], bounds[b + k + 1]
            if start >= end:
                warps.append(None)
                continue
            outs, hold, (cur, acc, piece), edge = _walk(
                rows, a["walk_nz"], a["csr_col"], val, x, start, end, lo,
                hi, G)
            _store(out, writes, outs)
            pieces = {}
            if edge[2] and edge[0] != edge[1]:
                pieces[0] = hold
            if piece:
                pieces[int(cur != edge[0])] = acc
            else:
                _store(out, writes, {cur: acc})
            warps.append((edge, pieces))
        for k, wk in enumerate(warps):
            if wk is None:
                continue
            (first, last, cs, ce), pieces = wk
            if ce and not (first == last and cs):
                acc = pieces[int(last != first)]
                for (f2, l2, _, ce2), p2 in warps[k + 1:]:
                    acc = acc + p2[0]
                    if not (f2 == l2 and ce2):
                        break
                _store(out, writes, {last: acc})
    _store(out, writes, {r: 0.0 for r in a["empty_rows"]})
    return out, writes


def _rowwalk_rows(plan, x, vals=None):
    """bsr_spmm_rowwalk a warp a row: warp w sums its row's nonzeros in
    column order and stores it; the zero fill."""
    a = _np(plan)
    val = (plan.csr_val if vals is None else vals).numpy()
    out = np.full((plan.n_rows, x.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.n_rows, int)
    bounds = a["walk_warp"]
    for start, end in zip(bounds[:-1], bounds[1:]):
        if start >= end:
            continue
        p0 = a["walk_nz"][start]
        acc = np.zeros(x.shape[1], np.float32)
        for j in range(p0, p0 + end - start):
            acc = acc + np.float32(val[j]) * x[a["csr_col"][j]]
        _store(out, writes, {a["csr_row"][p0]: acc})
    _store(out, writes, {r: 0.0 for r in a["empty_rows"]})
    return out, writes


def _blockpar_regs(plan, x, vals=None, chunk=T.CHUNK_MAX):
    """bsr_spmm_blockpar with register gathers: warp w sums chunk w's
    nonzeros in order; a row inside the chunk goes to out, another to
    scratch slot 2w + (the row starts after the chunk's start); then pass 2
    over ``cross_rows`` of that chunk and the zero fill."""
    a = _np(plan)
    ptr, row, col = a["csr_ptr"], a["csr_row"], a["csr_col"]
    val = (plan.csr_val if vals is None else vals).numpy()
    out = np.full((plan.n_rows, x.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.n_rows, int)
    scratch = {}
    for w in range(-(-plan.nnz // chunk)):
        start, end = w * chunk, min(plan.nnz, (w + 1) * chunk)
        acc, cur = np.zeros(x.shape[1], np.float32), row[start]
        for j in range(start, end + 1):
            if j == end or row[j] != cur:
                if ptr[cur] >= start and ptr[cur + 1] <= end:
                    _store(out, writes, {cur: acc})
                else:
                    key = 2 * w + int(ptr[cur] > start)
                    assert key not in scratch
                    scratch[key] = acc
                if j == end:
                    break
                acc, cur = np.zeros(x.shape[1], np.float32), row[j]
            acc = acc + np.float32(val[j]) * x[col[j]]
    for r, s0, k1 in T.cross_rows(ptr, chunk).reshape(-1, 3):
        acc = scratch[s0]
        for k in range(s0 // 2 + 1, k1 + 1):
            acc = acc + scratch[2 * k]
        _store(out, writes, {r: acc})
    _store(out, writes, {r: 0.0 for r in a["empty_rows"]})
    return out, writes


KERNELS = {"blockpar": _blockpar, "rowwalk": _rowwalk}


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("case", CASES)
def test_emulated_schedule_equals_plain(case, kernel, G):
    """Each ring kernel's schedule (the row walk's CTA ranges), walked in
    numpy, writes every row once and gives the plain CSR product, with the
    plan's values and with values given per call."""
    plan = _forced(PLANS[case], False)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((plan.n_cols, 12)).astype(np.float32)
    vals = torch.from_numpy(rng.random(plan.nnz).astype(np.float32) + 0.1)
    for v in (None, vals):
        out, writes = KERNELS[kernel](plan, x, G, vals=v)
        assert (writes == 1).all()
        ref = T.bsr_spmm_csr_plain(plan, torch.from_numpy(x), v).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL,
                                   atol=RTOL * max(np.abs(ref).max(), 1e-30))


REGISTER_KERNELS = {
    "rowwalk_rows": lambda plan, x, vals=None: _rowwalk_rows(
        _forced(plan, True), x, vals),
    "blockpar_regs": _blockpar_regs}


@pytest.mark.parametrize("kernel", sorted(REGISTER_KERNELS))
@pytest.mark.parametrize("case", CASES)
def test_emulated_register_schedules_equal_plain(case, kernel):
    """The register kernels' schedules (a warp a row; the first pass in
    chunks of CHUNK_MAX, its pieces in the ring pass's scratch slots, so
    pass 2 and ``cross_rows`` serve both) write every row once and give the
    plain CSR product, with the plan's values and with values per call."""
    plan = PLANS[case]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((plan.n_cols, 12)).astype(np.float32)
    vals = torch.from_numpy(rng.random(plan.nnz).astype(np.float32) + 0.1)
    for v in (None, vals):
        out, writes = REGISTER_KERNELS[kernel](plan, x, vals=v)
        assert (writes == 1).all()
        ref = T.bsr_spmm_csr_plain(plan, torch.from_numpy(x), v).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL,
                                   atol=RTOL * max(np.abs(ref).max(), 1e-30))


# (n_rows, n_cols, density, d): the JAX package's block-parallel branch
# (_spmm_v2_kernel) and its row-walk branch (_spmm_kernel: n_cols * d * 4
# over 10 MB), as test_torch_bsr_spmm.py runs them
BRANCHES = {"blockpar": (300, 300, 0.05, 128),
            "rowwalk": (512, 20480, 0.0003, 256)}


@pytest.mark.parametrize("G", (1, 32))
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_emulated_schedules_equal_pallas_interpret(branch, G):
    """Every schedule (the ring kernels', and the register kernels' once at
    G = 1, where they take no lane groups) against the Pallas kernel of
    the branch the JAX package takes at this shape, in interpret mode."""
    n_rows, n_cols, density, d = BRANCHES[branch]
    rng = np.random.default_rng(3)
    m = sp.coo_matrix(_rand(rng, n_rows, n_cols, density))
    plan = T.build_block_plan(m)
    jplan = J.build_block_plan(m)
    assert (plan.n_cols * d * 4 > J._V2_X_VMEM_BUDGET) == (branch ==
                                                           "rowwalk")
    x = rng.standard_normal((plan.n_cols, d)).astype(np.float32)
    ref = np.asarray(J._block_spmm_raw(jplan, jnp.asarray(x), interpret=True))
    ring = _forced(plan, False)
    for emulate in KERNELS.values():
        out, writes = emulate(ring, x, G)
        assert (writes == 1).all()
        np.testing.assert_allclose(out, ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max())
    for emulate in REGISTER_KERNELS.values():
        out, writes = emulate(plan, x)
        assert (writes == 1).all()
        np.testing.assert_allclose(out, ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max())
