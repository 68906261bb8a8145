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

Wrappers: on a CPU tensor a kernel wrapper runs the plain version over the
plan's CSR; on a CUDA tensor it launches the kernel (built from
``csrc/bsr_spmm.cu`` at first use) or raises.  Each wrapper counts its
launches in ``.launches``.  ``bsr_spmm_plain`` multiplies the dense blocks
and is a second, independent oracle.

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

import numpy as np
import scipy.sparse as sp
import torch

BLOCK = 128
#: d must be a multiple of this: the kernels move x rows 16 bytes at a
#: time, 4 f32 values (D_ALIGN) or 8 bf16 values (D_ALIGN_BF16)
D_ALIGN = 4
D_ALIGN_BF16 = 8
#: nonzeros per chunk of bsr_spmm_blockpar's first pass
CHUNK = 128
#: longest row ``dispatch`` gives the row walk: one warp walks a row on one
#: SM, so a plan with longer rows goes to bsr_spmm_blockpar, whose chunks
#: spread a row over many SMs
ROWWALK_MAX_ROW = 256

_CSR_FIELDS = ("csr_ptr", "csr_col", "csr_row", "csr_val", "row_order")


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """One matrix (one direction) in CSR: all that the kernels read.

    csr_ptr:     int32[n_rows+1] nonzero range per row.
    csr_col:     int32[nnz] column per nonzero, ascending within a row.
    csr_row:     int32[nnz] row per nonzero (non-decreasing): how
                 bsr_spmm_blockpar's chunks of the nonzero stream find
                 their rows.
    csr_val:     f32[nnz] the values, zeros left out.
    row_order:   int32[n_rows] the order in which bsr_spmm_rowwalk's warps
                 take rows: rows of one group (rows that share columns,
                 e.g. one node's slot rows in a pyramid) side by side,
                 groups with the most nonzeros first.
    max_row_nnz: the longest row's nonzero count.
    n_rows / n_cols: output / input sizes.
    """

    csr_ptr: torch.Tensor
    csr_col: torch.Tensor
    csr_row: torch.Tensor
    csr_val: torch.Tensor
    row_order: torch.Tensor
    max_row_nnz: int
    n_rows: int
    n_cols: int

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


def _csr_fields(r, c, val, n_rows, row_group):
    """CsrPlan fields from nonzeros sorted by (row, col), zeros left out."""
    counts = np.bincount(r, minlength=n_rows)
    return dict(
        csr_ptr=torch.from_numpy(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)),
        csr_col=torch.from_numpy(c.astype(np.int32)),
        csr_row=torch.from_numpy(r.astype(np.int32)),
        csr_val=torch.from_numpy(val.astype(np.float32)),
        row_order=torch.from_numpy(_walk_order(
            counts, np.arange(n_rows) if row_group is None
            else np.asarray(row_group)).astype(np.int32)),
        max_row_nnz=int(counts.max(initial=0)))


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
    walk's arguments, or the block-parallel kernel's with its scratch;
    ``extra`` goes before the stream (the bf16 entry points' out_f32).
    The kernel reads ``vals`` in place of ``plan.csr_val`` when given."""
    from ctgcn_torch.ops.cuda_build import load_kernels

    lib = load_kernels()
    val_ptr = (plan.csr_val if vals is None else vals).data_ptr()
    d = x.shape[1]
    out = torch.empty(plan.n_rows, d, device=x.device, dtype=out_dtype)
    with torch.cuda.device(x.device):
        if name.startswith("bsr_spmm_rowwalk"):
            rc = getattr(lib, name)(
                plan.csr_ptr.data_ptr(), plan.csr_col.data_ptr(),
                val_ptr, plan.row_order.data_ptr(),
                x.data_ptr(), out.data_ptr(), plan.n_rows, d, *extra,
                _stream(x))
        else:
            # f32 partial sums of rows across chunk edges, whatever x's type
            scratch = torch.empty(2 * -(-plan.nnz // CHUNK), d,
                                  device=x.device)
            rc = getattr(lib, name)(
                plan.csr_ptr.data_ptr(), plan.csr_row.data_ptr(),
                plan.csr_col.data_ptr(), val_ptr,
                x.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                plan.n_rows, plan.nnz, CHUNK, d, *extra, _stream(x))
    _raise_on(rc, name)
    return out


def bsr_spmm_rowwalk(plan: CsrPlan, x: torch.Tensor,
                     vals: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` by the row-walk kernel (counterpart of ``_spmm_kernel``,
    ``ctgcn_tpu/ops/pallas_spmm.py:97``).

    A warp walks an output row's nonzeros in column order: (col, val) 32 at
    a time, x rows gathered as float4, FP32 FFMA in registers, the row
    stored once (zeros for an empty row): deterministic, no scratch.
    Bound by bytes on the card, mostly the gathers of x rows from L2, so
    warps take rows in ``plan.row_order``, which puts rows that share
    columns (a node's core slots) in one CUDA block, where the repeats hit
    L1.  A row stays on one SM, so plans with long rows are slow here
    (``dispatch`` sends them to ``bsr_spmm_blockpar``).

    x: contiguous f32 [n_cols, d], d a multiple of 4 -> f32 [n_rows, d];
    vals: optional contiguous f32 [nnz] in place of ``plan.csr_val``.
    """
    _check(plan, x, vals=vals)
    if x.device.type == "cpu":
        return bsr_spmm_csr_plain(plan, x, vals)
    out = _launch("bsr_spmm_rowwalk", plan, x, torch.float32, vals=vals)
    bsr_spmm_rowwalk.launches += 1
    return out


bsr_spmm_rowwalk.launches = 0


def bsr_spmm_blockpar(plan: CsrPlan, x: torch.Tensor,
                      vals: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` by the block-parallel kernel (counterpart of
    ``_spmm_v2_kernel``, ``ctgcn_tpu/ops/pallas_spmm.py:146``).

    The TPU kernel's grid runs over blocks and carries each output tile
    across its row run; on Hopper nothing carries between CUDA blocks, and
    the blocks are nearly empty.  So the grid runs over equal chunks of
    ``CHUNK`` nonzeros, and long rows spread over many SMs.  Pass 1 writes
    every row that lies inside one chunk straight to out and leaves the
    pieces of rows that cross a chunk edge in scratch (two rows of d per
    chunk); pass 2 adds each such row's pieces in chunk order and writes
    empty rows as zeros (deterministic, no atomics).  Pass 2 is a
    programmatic dependent launch that starts in pass 1's last wave.
    Bound by bytes, like the row walk.

    x: contiguous f32 [n_cols, d], d a multiple of 4 -> f32 [n_rows, d];
    vals: optional contiguous f32 [nnz] in place of ``plan.csr_val``.
    """
    _check(plan, x, vals=vals)
    if x.device.type == "cpu":
        return bsr_spmm_csr_plain(plan, x, vals)
    out = _launch("bsr_spmm_blockpar", plan, x, torch.float32, vals=vals)
    bsr_spmm_blockpar.launches += 1
    return out


bsr_spmm_blockpar.launches = 0


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
    out = _launch("bsr_spmm_rowwalk_bf16", plan, x, out_dtype,
                  int(out_dtype == torch.float32))
    bsr_spmm_rowwalk_bf16.launches += 1
    return out


bsr_spmm_rowwalk_bf16.launches = 0


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
    out = _launch("bsr_spmm_blockpar_bf16", plan, x, out_dtype,
                  int(out_dtype == torch.float32))
    bsr_spmm_blockpar_bf16.launches += 1
    return out


bsr_spmm_blockpar_bf16.launches = 0


def dispatch(plan: CsrPlan, bf16: bool = False):
    """The kernel wrapper that runs ``plan`` (the ``*_bf16`` one for x in
    bf16).  The TPU package chose by the size of x (10 MB, what stays
    resident in VMEM); on the H100 the longest row decides.  A row walk
    keeps a row on one SM, which a hub row holds up (the pyramid's
    transpose: up to 16x a node's degree); the block-parallel kernel's
    equal chunks spread it over many SMs and pay a second pass for it.  At
    UCI (snapshot 2004-05, d = 512, NVIDIA H100 80GB HBM3, 700 W) the row
    walk is the faster on the forward plan (longest row 198) and the
    block-parallel kernel on the transpose (longest row 1977); at Enron
    both delta plans have a hub row (1130 and 1147 nonzeros) and the
    block-parallel kernel takes both.  ``chip_smoke.py`` times both on
    both."""
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
