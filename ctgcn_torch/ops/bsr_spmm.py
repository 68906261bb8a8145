# coding: utf-8
"""Block-sparse (BSR) SpMM with 128x128 blocks: plans, the two CUDA
kernels' wrappers, their plain PyTorch versions, and the differentiable
``block_spmm`` / ``pyramid_spmm`` (port of ``ctgcn_tpu/ops/pallas_spmm.py``).

The adjacency is tiled into 128x128 blocks and empty blocks are dropped,
as in the JAX package.  Beside the blocks a plan keeps the same matrix in
CSR (its nonzeros only); the CUDA kernels read only that, since the blocks
of a graph are nearly empty (0.38 % fill at UCI).  ``block_spmm``'s
backward runs ``dx = A^T g`` through a precomputed transpose plan; the
matrix values are graph data and get no gradient.

The kernels take a ``CsrPlan`` (the CSR alone), so plans that never had
blocks, such as the ELL backend's (``ops/ell.py``), run on them too; a
``BlockPlan`` is a ``CsrPlan`` with the blocks beside it.  ``csr_spmm`` is
the differentiable product over two ``CsrPlan``s that both backends share.
Every plan carries the kernels' schedule, built once on the host from its
CSR (``_schedule``): the chunk of the block-parallel kernel and the rows
across its edges, the runs of empty rows, and the row walk's stream and
warp ranges.

Wrappers: on a CPU tensor a kernel wrapper runs the plain version over the
plan's CSR; on a CUDA tensor it launches the kernel (built from
``csrc/bsr_spmm.cu`` at first use) or raises.  Each launch is counted in
the host counter ``spmm.launches.<wrapper name>``
(``training.profiling.counter``) and, while tracing is on, is an ``spmm``
span with a record of its plan, d and kernel.  ``bsr_spmm_plain``
multiplies the dense blocks and is a second, independent oracle.

The f32 wrappers also take the values as an argument (``vals``, one f32
per nonzero in plan order) in place of the plan's ``csr_val``: the edge
values that a model computes every step (GAT's attention, through
``ell.ell_spmm_ev``) reach the kernels that way, on a plan built once.

Each kernel has an f32 wrapper and a bf16 one (``*_bf16``: x in bf16, out
in bf16 or f32), the counterpart of the JAX package's bf16 gathers
(``ell_spmm(..., bf16=True)``); ``bsr_spmm_csr_plain_bf16`` is their plain
version.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.training import profiling

BLOCK = 128
#: d must be a multiple of this: the kernels move x rows 16 bytes at a
#: time, 4 f32 values (D_ALIGN) or 8 bf16 values (D_ALIGN_BF16)
D_ALIGN = 4
D_ALIGN_BF16 = 8
#: SMs of the card the schedules are built for (the H100 SXM's 132)
SMS = 132
#: bounds of the chunk of bsr_spmm_blockpar's first pass (nonzeros a warp)
CHUNK_MIN, CHUNK_MAX = 16, 128
#: warps the first pass aims for: 16 on each SM, a quarter of the 64 a SM
#: holds, each with 16 gathers in flight
CHUNK_WARPS = 16 * SMS
#: nonzeros from which the first pass gathers into registers, in chunks of
#: CHUNK_MAX (``chunk_regs``, f32 x): chunks of CHUNK_MAX / 2 then give
#: every SM its 16 warps, and the ring's shared memory, not the warps, caps
#: the loads in flight (UCI's pyramid transpose, 195,703 nonzeros: 0.0652
#: against the ring's 0.0793 ms at d = 512; Enron's GCN plans, 114,946:
#: the ring's 0.1478 against 0.1544; ``chip_smoke.py --compare``, NVIDIA
#: H100 80GB HBM3, 700 W)
REGS_NNZ = CHUNK_MAX // 2 * CHUNK_WARPS
#: warps of a CUDA block (CTA) in both kernels; the row walk's CTA takes
#: about WALK_WARPS chunks of its walk stream
WALK_WARPS = 8
#: dynamic shared memory a CTA of either kernel takes: the rings of its
#: warps, 16 cells of 16 bytes a lane (csrc/bsr_spmm.cu RING_BYTES)
SMEM_PER_CTA = WALK_WARPS * 32 * 16 * 16
#: x rows a lane of a warp-a-row walk gathers at once (csrc LOADS at
#: NV = 1): a row of at most this many nonzeros is one round of gathers, so
#: a plan of such rows too small to give every SM a CTA of the ring walk
#: goes a warp a row (Enron's GCN remote halo parts, about 2,000 nonzeros:
#: 0.0173-0.0175 against the ring's 0.0196-0.0197 ms at d = 500,
#: 0.0060-0.0062 against 0.0091-0.0092 at d = 128; ``chip_smoke.py
#: --compare``)
ROW_LOADS = 8
#: most rows of a run of empty rows that one warp of the zero fill writes
FILL_RUN = 4
#: nonzeros per distinct (walk group, column) from which the row walk takes
#: a warp a row (``walk_rows``): the groups' rows then name mostly the same
#: x rows, as a node's nested core slots do (UCI's pyramid: 9.8, 0.0431
#: against the ring's 0.0819 ms at d = 512; every other plan the port
#: builds: 1.0)
SHARED_COLUMNS = 2.0
#: longest row ``dispatch`` gives the row walk: a row stays in one CTA (one
#: SM), so a plan with longer rows goes to bsr_spmm_blockpar, whose chunks
#: spread a row over many SMs
ROWWALK_MAX_ROW = 256

_CSR_FIELDS = ("csr_ptr", "csr_col", "csr_row", "csr_val", "row_order",
               "empty_runs", "cross_rows", "walk_nz", "walk_warp")


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """One matrix (one direction) in CSR: all that the kernels read.

    csr_ptr:     int32[n_rows+1] nonzero range per row.
    csr_col:     int32[nnz] column per nonzero, ascending within a row.
    csr_row:     int32[nnz] row per nonzero (non-decreasing): how
                 bsr_spmm_blockpar's chunks of the nonzero stream find
                 their rows.
    csr_val:     f32[nnz] the values, zeros left out.
    row_order:   int32[n_rows] the order in which bsr_spmm_rowwalk takes
                 rows: rows of one group (rows that share columns, e.g.
                 one node's slot rows in a pyramid) side by side, groups
                 with the most nonzeros first.
    max_row_nnz: the longest row's nonzero count.
    n_rows / n_cols: output / input sizes.

    The kernels' schedule, built once on the host from the CSR
    (``_schedule``):
    empty_runs:  int32[n_runs, 2] the rows with no nonzero as runs (first
                 row, rows) of at most FILL_RUN rows, which both kernels
                 write as zeros by streaming stores, a warp a run.
    chunk:       nonzeros per warp of bsr_spmm_blockpar's first pass
                 (``blockpar_chunk`` of nnz).
    chunk_regs:  whether that pass gathers into registers (nnz of at least
                 REGS_NNZ), not through the shared-memory ring; for f32 x
                 (bf16 x keeps the ring, at this chunk).
    cross_rows:  int32[n_cross, 3] the rows whose nonzeros cross a chunk's
                 edge, the only rows of its second pass: (row, the scratch
                 row of its first piece, its last chunk).
    walk_nz:     int32[nnz] the nonzeros in walk order: the rows of
                 ``row_order`` that have nonzeros, each row's in column
                 order (bsr_spmm_rowwalk's stream).
    walk_rows:   whether the row walk takes a warp a row: the walk
                 groups' rows share their columns (``_shares_columns``), or
                 the rows are short (at most ROW_LOADS nonzeros) and the
                 plan too small to give every SM a CTA of the ring walk.
    walk_warp:   int32[WALK_WARPS * n_cta + 1] the row walk's warp ranges
                 of that stream, WALK_WARPS to a CTA: with ``walk_rows`` a
                 row each (``_row_warps``), else about WALK_WARPS chunks a
                 CTA cut at the walk order's group edges, split evenly (a
                 row never crosses a CTA's edge; ``_walk_warps``).
    cols_read:   the columns that hold a nonzero, the x rows the kernels
                 gather (recorded with each launch while tracing is on).
    """

    csr_ptr: torch.Tensor
    csr_col: torch.Tensor
    csr_row: torch.Tensor
    csr_val: torch.Tensor
    row_order: torch.Tensor
    max_row_nnz: int
    n_rows: int
    n_cols: int
    empty_runs: torch.Tensor
    chunk: int
    cross_rows: torch.Tensor
    walk_nz: torch.Tensor
    walk_rows: bool
    walk_warp: torch.Tensor
    chunk_regs: bool
    cols_read: int

    @property
    def nnz(self) -> int:
        return int(self.csr_val.shape[0])

    def to(self, device) -> "CsrPlan":
        """The plan on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class BlockPlan(CsrPlan):
    """BSR plan of one matrix (one direction): a ``CsrPlan`` whose sizes
    are padded to multiples of 128, with the 128x128 blocks beside it.

    blocks:      f32[NB, 128, 128] dense blocks, sorted by row tile (host
                 plans; ``to`` leaves them behind unless asked).
    block_col:   int32[NB] column-tile index per block.
    block_row:   int32[NB] row-tile index per block (non-decreasing).
    row_ptr:     int32[R+1] block range per row tile (padding blocks from
                 :func:`pad_block_plan` sit past ``row_ptr[-1]``).
    The CSR holds the values the blocks hold.
    """

    blocks: torch.Tensor | None
    block_col: torch.Tensor
    block_row: torch.Tensor
    row_ptr: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return int(self.block_col.shape[0])

    def to(self, device, blocks: bool = False) -> "BlockPlan":
        """The plan on ``device``.  The dense blocks come along only with
        ``blocks=True``: no kernel reads them, only ``bsr_spmm_plain``."""
        moved = super().to(device)
        return moved if blocks else dataclasses.replace(moved, blocks=None)


def _walk_order(counts, group):
    """Rows grouped by ``group``, the groups with the most nonzeros first
    (so the longest work starts first), rows ascending within a group."""
    totals = np.bincount(group, weights=counts)[group]
    return np.lexsort((np.arange(len(counts)), group, -totals))


def blockpar_chunk(nnz: int, regs: bool | None = None) -> int:
    """bsr_spmm_blockpar's chunk for a plan of ``nnz`` nonzeros: CHUNK_MAX
    for the register pass (``regs``; by default from REGS_NNZ nonzeros on),
    else the largest power of two in [CHUNK_MIN, CHUNK_MAX] that still
    gives CHUNK_WARPS chunks.  A warp's chunk is a run of dependent rounds
    of gathers, so a small plan (AS's transpose: 32,508 nonzeros) needs
    small chunks to put gathers in flight on every SM; from REGS_NNZ the
    card is full and the register pass takes chunks of CHUNK_MAX, which
    leave fewer rows across their edges."""
    if nnz >= REGS_NNZ if regs is None else regs:
        return CHUNK_MAX
    chunk = CHUNK_MIN
    while chunk < CHUNK_MAX and 2 * chunk * CHUNK_WARPS <= nnz:
        chunk *= 2
    return chunk


def _walk_warps(lens, group_end, chunk):
    """The row walk's warp ranges of its stream, WALK_WARPS to a CTA, for
    rows of ``lens`` nonzeros in walk order whose groups end at stream
    positions ``group_end``.  A CTA takes about WALK_WARPS chunks: up to
    the first group end at or past each multiple of that budget, so that
    rows that share columns (a node's core slots) are gathered on one SM;
    a range over twice the budget (one large group) is cut at row ends
    too.  Its warps split it evenly, so short rows share a warp and a long
    row spreads over the CTA."""
    w = WALK_WARPS
    ends = np.cumsum(lens)
    nnz = int(ends[-1])
    targets = np.arange(w * chunk, nnz, w * chunk)
    hi = np.unique(np.concatenate(
        [group_end[np.searchsorted(group_end, targets)], [nnz]]))
    long = np.diff(np.concatenate([[0], hi])) > 2 * w * chunk
    if long.any():
        row_cuts = ends[np.searchsorted(ends, targets)]
        span = np.searchsorted(hi, row_cuts)
        hi = np.unique(np.concatenate(
            [hi, row_cuts[long[span] & (row_cuts < hi[span])]]))
    lo = np.concatenate([[0], hi[:-1]])
    per = -(-(hi - lo) // w)
    return np.append(np.minimum(hi[:, None], lo[:, None]
                                + per[:, None] * np.arange(w)), nnz)


def _row_warps(lens):
    """The row walk's warp ranges with a warp a row (``walk_rows``): the
    rows' stream ranges, WALK_WARPS to a CTA, the last CTA's spare warps
    empty."""
    bounds = np.concatenate([[0], np.cumsum(lens)])
    n = WALK_WARPS * -(-len(lens) // WALK_WARPS) + 1
    return np.concatenate([bounds, np.full(n - len(bounds), bounds[-1])])


def _shares_columns(grp, lens, cols):
    """Whether the walk groups' rows share their columns: nonzeros per
    distinct (group, column) pair of at least SHARED_COLUMNS.  ``grp`` and
    ``lens``: the group and length of each nonempty row in walk order;
    ``cols``: the stream's columns."""
    if len(cols) == 0 or np.all(grp[1:] != grp[:-1]):
        return False
    key = (np.repeat(grp.astype(np.int64), lens) * (int(cols.max()) + 1)
           + cols)
    return len(cols) >= SHARED_COLUMNS * np.unique(key).size


def _empty_runs(nonempty, n_rows):
    """int64[n_runs, 2]: the rows with no nonzero, the gaps between the
    ``nonempty`` rows (ascending), as runs (first row, rows) of at most
    FILL_RUN rows."""
    first = np.concatenate([[0], nonempty + 1])
    lens = np.concatenate([nonempty, [n_rows]]) - first
    first, lens = first[lens > 0], lens[lens > 0]
    n = -(-lens // FILL_RUN)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    start = np.repeat(first, n) + FILL_RUN * k
    return np.stack([start, np.minimum(FILL_RUN, np.repeat(first + lens, n)
                                       - start)], axis=1)


def cross_rows(ptr, chunk, nonempty=None):
    """int64[n_cross, 3]: each row whose nonzeros cross an edge of the
    chunks of ``chunk`` nonzeros, the scratch row of its first piece (slot
    0 of its first chunk k0 when the row starts that chunk, else slot 1)
    and its last chunk.  ``nonempty``: the rows with nonzeros, if known."""
    ptr = np.asarray(ptr, dtype=np.int64)
    rows = (np.flatnonzero(ptr[1:] > ptr[:-1]) if nonempty is None
            else nonempty)
    p0 = ptr[rows]
    k0, k1 = p0 // chunk, (ptr[rows + 1] - 1) // chunk
    cross = k1 > k0
    return np.stack([rows[cross], 2 * k0[cross] + (p0[cross]
                                                   > k0[cross] * chunk),
                     k1[cross]], axis=1)


def _schedule(counts, ptr, order, group, col, walk_rows=None,
              chunk_regs=None):
    """The kernels' schedule fields of a CSR (``CsrPlan``'s docstring):
    O(nnz + n_rows) numpy work, once per plan (and a sort of the stream's
    (group, column) pairs when groups hold several rows); ``group``: each
    row's group in the walk order.  ``walk_rows`` / ``chunk_regs``: each
    kernel's way of gathering, derived from the plan unless given."""
    nnz = int(ptr[-1])
    chunk_regs = nnz >= REGS_NNZ if chunk_regs is None else chunk_regs
    chunk = blockpar_chunk(nnz, chunk_regs)
    nonempty = np.flatnonzero(counts)
    rows = order[counts[order] > 0]
    lens = counts[rows]
    ends = np.cumsum(lens)
    walk_nz = np.repeat(ptr[rows] - (ends - lens), lens) + np.arange(nnz)
    grp = group[rows]
    group_end = ends[np.append(grp[1:] != grp[:-1], True)] if nnz else ends
    # the ring walk's CTAs take about WALK_WARPS of the ring pass's chunks
    walk_warp = (_walk_warps(lens, group_end, blockpar_chunk(nnz, False))
                 if nnz else np.zeros(1))
    if walk_rows is None:
        # rows that share columns, or short rows of a plan too small to
        # give every SM a CTA of the ring walk
        walk_rows = _shares_columns(grp, lens, np.asarray(col)[walk_nz]) or (
            0 < nnz and lens.max() <= ROW_LOADS
            and len(walk_warp) - 1 < WALK_WARPS * SMS)
    if walk_rows and nnz:
        walk_warp = _row_warps(lens)
    return dict(
        empty_runs=torch.from_numpy(
            _empty_runs(nonempty, len(counts)).astype(np.int32)),
        chunk=chunk, chunk_regs=bool(chunk_regs),
        cross_rows=torch.from_numpy(
            cross_rows(ptr, chunk, nonempty).astype(np.int32)),
        walk_nz=torch.from_numpy(walk_nz.astype(np.int32)),
        walk_rows=bool(walk_rows and nnz),
        walk_warp=torch.from_numpy(walk_warp.astype(np.int32)),
        cols_read=int(np.count_nonzero(np.bincount(np.asarray(col)))))


def _csr_fields(r, c, val, n_rows, row_group):
    """CsrPlan fields from nonzeros sorted by (row, col), zeros left out."""
    counts = np.bincount(r, minlength=n_rows)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    group = (np.arange(n_rows) if row_group is None
             else np.asarray(row_group))
    order = _walk_order(counts, group)
    return dict(
        csr_ptr=torch.from_numpy(ptr.astype(np.int32)),
        csr_col=torch.from_numpy(c.astype(np.int32)),
        csr_row=torch.from_numpy(r.astype(np.int32)),
        csr_val=torch.from_numpy(val.astype(np.float32)),
        row_order=torch.from_numpy(order.astype(np.int32)),
        max_row_nnz=int(counts.max(initial=0)),
        **_schedule(counts, ptr, order, group, c))


def with_row_order(plan: CsrPlan, order, group=None, walk_rows=None,
                   chunk_regs=None) -> CsrPlan:
    """``plan`` walked in ``order`` (int[n_rows], a permutation of rows
    grouped by ``group``; default: each row its own group): ``row_order``
    and the schedule rebuilt from the plan's CSR, on the plan's device.
    ``walk_rows`` / ``chunk_regs`` force a kernel's way of gathering (to
    time the one the plan's rule did not pick)."""
    ptr = plan.csr_ptr.cpu().numpy().astype(np.int64)
    order = np.asarray(order, dtype=np.int64)
    group = np.arange(len(order)) if group is None else np.asarray(group)
    fields = _schedule(np.diff(ptr), ptr, order, group,
                       plan.csr_col.cpu().numpy(), walk_rows, chunk_regs)
    dev = plan.csr_ptr.device
    return dataclasses.replace(
        plan, row_order=torch.from_numpy(order.astype(np.int32)).to(dev),
        **{k: v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in fields.items()})


def lane_groups(d: int, bf16: bool = False, by_row: bool = False):
    """(g, G, NV, slices) of the kernels at width d (csrc/bsr_spmm.cu
    ``geometry`` and ``row_geometry``): G groups of g lanes a warp, each
    lane NV 16-byte pieces of an x row, grid-y slices.  The ring kernels:
    at d <= 16 pieces (64 f32, 128 bf16 values) the narrowest group that
    covers d; else one group of 32 lanes over up to 4 (f32) or 2 (bf16)
    pieces a lane, slices of 512 columns.  ``by_row``: the register
    gathers (``walk_rows``, ``chunk_regs``), one group of 32 lanes over up
    to 2 pieces a lane.  ``_library`` holds these against the kernels'
    own."""
    vec, max_nv = (8, 2) if bf16 else (4, 4)
    per = -(-d // (32 * vec))
    if by_row:
        return 32, 1, (1 if per <= 1 else 2), (1 if per <= 2 else -(-per // 2))
    if d <= 16 * vec:
        g = 1
        while g * vec < d:
            g *= 2
        return g, 32 // g, 1, 1
    if per <= max_nv:
        return 32, 1, (1 if per <= 1 else 2 if per <= 2 else 4), 1
    return 32, 1, max_nv, -(-per // max_nv)


def _library():
    """The kernel library, built and loaded on first use, its launch
    geometry and constants held against this module's copy of them
    (``_check_geometry``)."""
    from ctgcn_torch.ops.cuda_build import load_kernels

    lib = load_kernels()
    _check_geometry(lib)
    return lib


@functools.cache
def _check_geometry(lib):
    """Raise unless the kernels' own launch geometry (``bsr_spmm_geometry``)
    is ``lane_groups``' at every width, and their WARPS, RING_BYTES and
    LOADS are WALK_WARPS, SMEM_PER_CTA and ROW_LOADS, with which the host
    builds the schedules."""
    got = np.zeros(6, np.int32)
    for bf16, align in ((False, D_ALIGN), (True, D_ALIGN_BF16)):
        for by_row in (False, True):
            for d in range(align, 2049, align):
                lib.bsr_spmm_geometry(d, int(bf16), int(by_row),
                                      got.ctypes.data)
                g, _, nv, slices = lane_groups(d, bf16, by_row)
                want = (g, nv, slices, WALK_WARPS, SMEM_PER_CTA, ROW_LOADS)
                if tuple(got) != want:
                    raise RuntimeError(
                        f"the kernels' geometry at d={d} (bf16 {bf16}, "
                        f"by_row {by_row}) is {tuple(got)}; bsr_spmm.py "
                        f"builds for {want}")


def schedule_stats(plan: CsrPlan) -> dict:
    """The schedule's sizes: the chunk and its count, the rows across a
    chunk's edge, the empty rows and their runs, whether each kernel
    gathers into registers, the row walk's CTAs and its split rows (rows
    that cross a warp's edge inside a CTA), and the shared memory a CTA of
    each kernel takes."""
    bounds = plan.walk_warp.cpu().numpy().astype(np.int64)
    cta = bounds[:-1].reshape(-1, WALK_WARPS)
    lo = cta[:, :1]
    hi = np.append(cta[1:, 0], bounds[-1])[:, None]
    edges = cta[:, 1:][(cta[:, 1:] > lo) & (cta[:, 1:] < hi)]
    row = plan.csr_row.cpu().numpy()[plan.walk_nz.cpu().numpy()]
    split = row[edges][row[edges - 1] == row[edges]]
    runs = plan.empty_runs.cpu().numpy()
    return {"chunk": plan.chunk, "chunks": -(-plan.nnz // plan.chunk),
            "cross_rows": int(plan.cross_rows.shape[0]),
            "empty_rows": int(runs[:, 1].sum()), "empty_runs": len(runs),
            "chunk_regs": plan.chunk_regs,
            "walk_rows": plan.walk_rows, "walk_ctas": len(cta),
            "split_rows": int(np.unique(split).size),
            "smem_per_cta": {
                "rowwalk": 0 if plan.walk_rows else SMEM_PER_CTA,
                "blockpar": 0 if plan.chunk_regs else SMEM_PER_CTA,
                "blockpar_bf16": SMEM_PER_CTA}}


def build_csr_plan(mat, row_group=None) -> CsrPlan:
    """scipy sparse matrix -> CsrPlan (host tensors) of the same shape:
    duplicates summed in float64, then stored as float32, zeros left out.

    Args:
      row_group: int[n_rows] group of each row for the row walk's order
        (see ``build_block_plan``).  Default: each row its own group."""
    csr = sp.csr_matrix(mat, dtype=np.float64, copy=True)
    csr.sum_duplicates()
    csr.sort_indices()
    val = csr.data.astype(np.float32)
    keep = val != 0
    r = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    n_rows, n_cols = csr.shape
    return CsrPlan(**_csr_fields(r[keep], csr.indices[keep], val[keep],
                                 n_rows, row_group),
                   n_rows=int(n_rows), n_cols=int(n_cols))


def build_block_plan(mat, block=BLOCK, row_group=None) -> BlockPlan:
    """scipy sparse matrix -> BlockPlan (host tensors).

    Every row tile gets at least one block (a zero filler in column tile 0
    for a tile with no data), as in the JAX package.  The CSR holds every
    distinct (row, col) of ``mat`` with the value its block holds
    (duplicates summed), zeros left out, so fillers add nothing to it.

    Args:
      row_group: int[n_rows] (padded) group of each row for the row walk's
        order; rows of a group should share columns.  Default: each row
        its own group."""
    coo = mat.tocoo()
    n_rows = -(-mat.shape[0] // block) * block
    n_cols = -(-mat.shape[1] // block) * block
    c_tiles = n_cols // block
    r_tiles = n_rows // block
    key = (coo.row // block).astype(np.int64) * c_tiles + coo.col // block
    uniq, inv = np.unique(key, return_inverse=True)
    empty_rt = np.setdiff1d(np.arange(r_tiles, dtype=np.int64),
                            uniq // c_tiles)
    all_keys = np.sort(np.concatenate([uniq, empty_rt * c_tiles]))
    blocks = np.zeros((len(all_keys), block, block), np.float32)
    slot_of_uniq = np.searchsorted(all_keys, uniq)
    np.add.at(blocks,
              (slot_of_uniq[inv.reshape(-1)], coo.row % block,
               coo.col % block),
              coo.data.astype(np.float32))
    u_rt = (all_keys // c_tiles).astype(np.int32)
    u_ct = (all_keys % c_tiles).astype(np.int32)
    row_ptr = np.zeros(r_tiles + 1, np.int32)
    np.add.at(row_ptr[1:], u_rt, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)

    # the nonzero view, read back from the blocks
    lin = np.unique(coo.row.astype(np.int64) * n_cols + coo.col)
    r, c = lin // n_cols, lin % n_cols
    val = blocks[np.searchsorted(all_keys, (r // block) * c_tiles
                                 + c // block), r % block, c % block]
    keep = val != 0
    return BlockPlan(
        blocks=torch.from_numpy(blocks), block_col=torch.from_numpy(u_ct),
        block_row=torch.from_numpy(u_rt), row_ptr=torch.from_numpy(row_ptr),
        **_csr_fields(r[keep], c[keep], val[keep], n_rows, row_group),
        n_rows=int(n_rows), n_cols=int(n_cols))


def build_block_plans(mat, block=BLOCK):
    """(forward_plan, transpose_plan) for the SpMM and its backward."""
    return build_block_plan(mat, block), build_block_plan(mat.T, block)


def pad_block_plan(plan: BlockPlan, nb: int) -> BlockPlan:
    """Pad the block bank of a host plan to ``nb`` blocks (the JAX
    package's way to give a window's plans one size; the port's windows
    keep each snapshot's own plan).  Padding blocks are zero, lie past
    ``row_ptr[-1]`` and repeat the last row tile; they hold no nonzero, so
    the CSR, which is all the kernels read, stays as it was."""
    cur = plan.num_blocks
    if cur > nb:
        raise ValueError(f"plan has {cur} blocks > pad target {nb}")
    if cur == nb:
        return plan
    pad = nb - cur
    return dataclasses.replace(
        plan,
        blocks=torch.cat([plan.blocks, plan.blocks.new_zeros(pad, BLOCK,
                                                             BLOCK)]),
        block_col=torch.cat([plan.block_col,
                             plan.block_col.new_zeros(pad)]),
        block_row=torch.cat([plan.block_row,
                             plan.block_row[cur - 1:].expand(pad)]))


def build_pyramid_plans(slot_mats, n_nodes, num_slots, block=BLOCK):
    """BSR plans for a whole k-core pyramid: the K slot products
    ``A_k @ x`` as one product with the slots stacked vertically into a
    [K*Np, Np] matrix (Np = N padded to the block size), and its transpose
    [Np, K*Np] for the backward (dx = sum_k A_k^T g_k).

    Args:
      slot_mats: list of (slot_index, scipy [N, N]) for the kept slots;
        absent slots contribute no blocks (their row tiles get fillers).
    Returns (fwd_plan, t_plan) as host plans.
    """
    np_pad = -(-n_nodes // block) * block
    rows, cols, vals = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [
        np.zeros(0, np.float32)]
    for k, mat in slot_mats:
        coo = mat.tocoo()
        keep = coo.data != 0
        rows.append(coo.row[keep].astype(np.int64) + k * np_pad)
        cols.append(coo.col[keep].astype(np.int64))
        vals.append(coo.data[keep].astype(np.float32))
    stacked = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(num_slots * np_pad, np_pad))
    # a node's slot rows share most of their columns (nested cores): the
    # row walk takes them side by side
    node_of_row = np.arange(num_slots * np_pad) % np_pad
    return (build_block_plan(stacked, block, row_group=node_of_row),
            build_block_plan(stacked.T, block))


# ---------------------------------------------------------------------------
# the kernels: plain versions and wrappers
# ---------------------------------------------------------------------------

def _check(plan: CsrPlan, x: torch.Tensor, dtype=torch.float32,
           vals=None):
    align = D_ALIGN_BF16 if dtype == torch.bfloat16 else D_ALIGN
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {dtype} [n_cols, d] tensor")
    if x.shape[0] != plan.n_cols or x.shape[1] % align:
        raise ValueError(f"x is {tuple(x.shape)}; the plan takes "
                         f"[{plan.n_cols}, multiple of {align}]")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    for name in _CSR_FIELDS:
        t = getattr(plan, name)
        want = torch.float32 if name == "csr_val" else torch.int32
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be a contiguous {want} "
                             f"tensor on {x.device}")
    if vals is not None and (
            vals.dtype != torch.float32 or vals.shape != (plan.nnz,)
            or not vals.is_contiguous() or vals.device != x.device):
        raise ValueError(f"vals must be a contiguous float32 [{plan.nnz}] "
                         f"tensor on {x.device}")
    # the kernels move x and out 16 bytes at a time
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def _check_out_dtype(out_dtype):
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, not "
                         f"{out_dtype}")


def _rows(plan: CsrPlan, device):
    return torch.repeat_interleave(
        torch.arange(plan.n_rows, device=device), plan.csr_ptr.diff())


def bsr_spmm_csr_plain(plan: CsrPlan, x, vals=None):
    """Plain version of both kernels over the arrays they read, ``A @ x``:
    gather ``x[col] * val`` per nonzero and add it into its row (rows from
    ``csr_ptr``); ``vals`` in place of ``csr_val`` when given."""
    vals = plan.csr_val if vals is None else vals
    out = x.new_zeros(plan.n_rows, x.shape[1])
    out.index_add_(0, _rows(plan, x.device),
                   x[plan.csr_col.long()] * vals[:, None])
    return out


def bsr_spmm_csr_plain_bf16(plan: CsrPlan, x, out_dtype=torch.bfloat16):
    """Plain version of the bf16 kernels, with the JAX package's bf16
    gather (``ctgcn_tpu/ops/ell.py:184-190``): x rows and values rounded
    to bf16, products (exact in f32) summed in f32, the sum cast once to
    ``out_dtype``."""
    xb = x.bfloat16().float()
    vals = plan.csr_val.bfloat16().float()
    out = xb.new_zeros(plan.n_rows, x.shape[1])
    out.index_add_(0, _rows(plan, x.device),
                   xb[plan.csr_col.long()] * vals[:, None])
    return out.to(out_dtype)


def bsr_spmm_plain(plan: BlockPlan, x):
    """``A @ x`` from the dense blocks, the second oracle: every row tile
    sums the products of the blocks in ``row_ptr[r] .. row_ptr[r+1]``
    (padding blocks past ``row_ptr[-1]`` are zero and left out).  Needs a
    plan that carries its blocks."""
    if plan.blocks is None:
        raise ValueError("the plan carries no dense blocks; move it with "
                         "BlockPlan.to(device, blocks=True)")
    nb = int(plan.row_ptr[-1])
    d = x.shape[1]
    tiles = x.view(-1, BLOCK, d)[plan.block_col[:nb].long()]
    out = x.new_zeros(plan.n_rows // BLOCK, BLOCK, d)
    out.index_add_(0, plan.block_row[:nb].long(),
                   torch.bmm(plan.blocks[:nb], tiles))
    return out.view(plan.n_rows, d)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _launch(name, plan: CsrPlan, x, out_dtype, *extra, vals=None):
    """Launch C entry point ``name`` on ``plan`` and x (CUDA): the row
    walk's arguments (its stream and warp ranges, the empty rows' runs), or
    the block-parallel kernel's (the crossing rows, the runs, the chunk)
    with its scratch;
    ``extra`` goes before the stream (the bf16 entry points' out_f32).
    The kernel reads ``vals`` in place of ``plan.csr_val`` when given.
    Counts the launch in ``spmm.launches.<name>``; an ``spmm`` span."""
    lib = _library()
    val_ptr = (plan.csr_val if vals is None else vals).data_ptr()
    d = x.shape[1]
    out = torch.empty(plan.n_rows, d, device=x.device, dtype=out_dtype)
    with torch.cuda.device(x.device), profiling.span("spmm"):
        if name.startswith("bsr_spmm_rowwalk"):
            rc = getattr(lib, name)(
                plan.csr_row.data_ptr(), plan.csr_col.data_ptr(), val_ptr,
                plan.walk_nz.data_ptr(), plan.walk_warp.data_ptr(),
                (plan.walk_warp.numel() - 1) // WALK_WARPS,
                int(plan.walk_rows), plan.empty_runs.data_ptr(),
                plan.empty_runs.shape[0],
                x.data_ptr(), out.data_ptr(), plan.n_rows, d, *extra,
                _stream(x))
        else:
            # f32 partial sums of rows across chunk edges, whatever x's type
            scratch = torch.empty(2 * -(-plan.nnz // plan.chunk), d,
                                  device=x.device)
            rc = getattr(lib, name)(
                plan.csr_ptr.data_ptr(), plan.csr_row.data_ptr(),
                plan.csr_col.data_ptr(), val_ptr, plan.cross_rows.data_ptr(),
                plan.cross_rows.shape[0],
                plan.empty_runs.data_ptr(), plan.empty_runs.shape[0],
                x.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                plan.n_rows, plan.nnz, plan.chunk,
                int(plan.chunk_regs), d, *extra, _stream(x))
    _raise_on(rc, name)
    profiling.count("spmm.launches." + name)
    trace = profiling.active()
    if trace is not None:
        trace.spmm.append((plan.nnz, plan.n_rows, plan.cols_read, d, name))
    return out


def bsr_spmm_rowwalk(plan: CsrPlan, x: torch.Tensor,
                     vals: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` by the row-walk kernel (counterpart of ``_spmm_kernel``,
    ``ctgcn_tpu/ops/pallas_spmm.py:97``).

    One launch: the CTAs walk the plan's rows in ``plan.row_order``, each
    about WALK_WARPS chunks of the walk stream cut at the order's group
    edges, so rows that share columns (a node's core slots) are gathered
    on one SM, and split evenly over its warps (``walk_warp``): short rows
    share a warp and a long row is split over the CTA's warps, whose pieces
    are added in shared memory in warp order.  x rows arrive through a
    ring in shared memory by asynchronous copies, FP32 FFMA in registers,
    each row stored once; more CTAs of the launch write the empty rows as
    zeros over their runs: deterministic, no scratch, no atomics.

    x: contiguous f32 [n_cols, d], d a multiple of 4 -> f32 [n_rows, d];
    vals: optional contiguous f32 [nnz] in place of ``plan.csr_val``.
    """
    _check(plan, x, vals=vals)
    if x.device.type == "cpu":
        return bsr_spmm_csr_plain(plan, x, vals)
    return _launch("bsr_spmm_rowwalk", plan, x, torch.float32, vals=vals)


def bsr_spmm_blockpar(plan: CsrPlan, x: torch.Tensor,
                      vals: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` by the block-parallel kernel (counterpart of
    ``_spmm_v2_kernel``, ``ctgcn_tpu/ops/pallas_spmm.py:146``).

    The TPU kernel's grid runs over blocks and carries each output tile
    across its row run; on Hopper nothing carries between CUDA blocks, and
    the blocks are nearly empty.  So a warp takes each chunk of
    ``plan.chunk`` nonzeros (derived from nnz so that small plans still
    fill the card), and long rows spread over many SMs.  Pass 1 writes
    every row that lies inside one chunk straight to out and leaves the
    pieces of rows that cross a chunk edge in scratch (two rows of d per
    chunk); pass 2 runs only over those rows (``plan.cross_rows``) and
    adds each one's pieces in chunk order; a zero fill writes the empty
    rows (deterministic, no atomics).  Pass 2 is a programmatic dependent
    launch, so its CTAs are resident when pass 1 ends.

    x: contiguous f32 [n_cols, d], d a multiple of 4 -> f32 [n_rows, d];
    vals: optional contiguous f32 [nnz] in place of ``plan.csr_val``.
    """
    _check(plan, x, vals=vals)
    if x.device.type == "cpu":
        return bsr_spmm_csr_plain(plan, x, vals)
    return _launch("bsr_spmm_blockpar", plan, x, torch.float32, vals=vals)


def bsr_spmm_rowwalk_bf16(plan: CsrPlan, x: torch.Tensor,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """``A @ x`` by the row-walk kernel with x in bf16: 16-byte loads of 8
    bf16 values, each value of A rounded to bf16 as it is read, products
    and sums in f32 FFMA, one rounding at the store when ``out_dtype`` is
    bf16 (the forward's slot products) and none for f32 (the backward's
    dx).  Half the gathered bytes of ``bsr_spmm_rowwalk``.

    x: contiguous bf16 [n_cols, d], d a multiple of 8 -> ``out_dtype``
    [n_rows, d]."""
    _check(plan, x, torch.bfloat16)
    _check_out_dtype(out_dtype)
    if x.device.type == "cpu":
        return bsr_spmm_csr_plain_bf16(plan, x, out_dtype)
    return _launch("bsr_spmm_rowwalk_bf16", plan, x, out_dtype,
                   int(out_dtype == torch.float32))


def bsr_spmm_blockpar_bf16(plan: CsrPlan, x: torch.Tensor,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """``A @ x`` by the block-parallel kernel with x in bf16 (the rounding
    of ``bsr_spmm_rowwalk_bf16``); the pieces of rows across chunk edges
    stay f32 until pass 2 adds them and stores the row once.

    x: contiguous bf16 [n_cols, d], d a multiple of 8 -> ``out_dtype``
    [n_rows, d]."""
    _check(plan, x, torch.bfloat16)
    _check_out_dtype(out_dtype)
    if x.device.type == "cpu":
        return bsr_spmm_csr_plain_bf16(plan, x, out_dtype)
    return _launch("bsr_spmm_blockpar_bf16", plan, x, out_dtype,
                   int(out_dtype == torch.float32))


def dispatch(plan: CsrPlan, bf16: bool = False):
    """The kernel wrapper that runs ``plan`` (the ``*_bf16`` one for x in
    bf16).  The TPU package chose by the size of x (10 MB, what stays
    resident in VMEM); on the H100 the longest row decides.  A row walk
    keeps a row in one CTA, which a hub row holds up (the transposes' rows
    of 865-1,977 nonzeros: AS's at d = 500 0.0555 ms against the
    block-parallel kernel's 0.0271); the block-parallel kernel spreads it
    over many chunks and pays a second pass for it, which costs it on
    plans of short rows (AS's forward at d = 500 0.0621 against the walk's
    0.0583; UCI's pyramid forward, a warp a row, 0.0630 against 0.0431).
    Re-derived on the rows of ``chip_smoke.py --compare``, which time both
    kernels on 40 (plan, width) pairs (NVIDIA H100 80GB HBM3, 700 W): the
    rule's sum is 3.1 % over the faster kernel's on each pair.  It loses
    more than 5 % on Math at d = 128 (0.0118 against 0.0106 ms) and
    Enron GAT's row sum at d = 4 (0.0095 against 0.0086); the best rule
    tried that reads d (the block-parallel kernel at d = 128 on plans with
    no empty row) comes to 2.9 %, so the rule reads the plan alone."""
    if plan.max_row_nnz <= ROWWALK_MAX_ROW:
        return bsr_spmm_rowwalk_bf16 if bf16 else bsr_spmm_rowwalk
    return bsr_spmm_blockpar_bf16 if bf16 else bsr_spmm_blockpar


def block_spmm_raw(plan: CsrPlan, x: torch.Tensor) -> torch.Tensor:
    """x: [n_cols, d] (d a multiple of 4) -> [n_rows, d]."""
    return dispatch(plan)(plan, x)


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels take it: contiguous float32, 16-byte aligned."""
    x = x.float().contiguous()
    return x.clone() if x.data_ptr() % 16 else x


class _CsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_plan, t_plan):
        ctx.t_plan = t_plan
        return block_spmm_raw(fwd_plan, x)

    @staticmethod
    def backward(ctx, g):
        return block_spmm_raw(ctx.t_plan, _kernel_input(g)), None, None


def csr_spmm(fwd_plan: CsrPlan, t_plan: CsrPlan, x):
    """``A @ x`` on the kernels, differentiable w.r.t. x: the backward runs
    ``dx = A^T g`` on the transpose plan (the JAX custom VJPs of
    ``block_spmm`` and ``ell_spmm``); the matrix gets no gradient.

    x: [n_cols, d], d a multiple of 4 -> [n_rows, d]."""
    return _CsrSpmm.apply(_kernel_input(x), fwd_plan, t_plan)


def block_spmm(fwd_plan: BlockPlan, t_plan: BlockPlan, x):
    """``A @ x`` with BSR plans, differentiable w.r.t. x.

    x: [n_cols_unpadded, d] -> [n_rows_padded, d].  Rows and the feature
    dim are zero-padded to multiples of 128 inside."""
    n_in, d = x.shape
    d_pad = -(-d // BLOCK) * BLOCK
    x_p = torch.nn.functional.pad(
        x.float(), (0, d_pad - d, 0, fwd_plan.n_cols - n_in))
    return csr_spmm(fwd_plan, t_plan, x_p)[:, :d]


def pyramid_spmm(fwd_plan: BlockPlan, t_plan: BlockPlan, x, num_slots,
                 n_nodes):
    """All K slot products of a core pyramid: x [N, d] -> [K, N, d]."""
    out = block_spmm(fwd_plan, t_plan, x)
    return out.reshape(num_slots, fwd_plan.n_cols, -1)[:, :n_nodes, :]
