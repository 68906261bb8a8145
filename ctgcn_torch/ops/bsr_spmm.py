# coding: utf-8
"""Block-sparse (BSR) SpMM with 128x128 blocks: plans, the two CUDA
kernels' wrappers, their plain PyTorch version, and the differentiable
``block_spmm`` / ``pyramid_spmm`` (port of ``ctgcn_tpu/ops/pallas_spmm.py``).

The adjacency is tiled into 128x128 blocks, empty blocks are dropped, and
each surviving block is multiplied against the matching 128-row tile of x.
``block_spmm``'s backward runs ``dx = A^T g`` through a precomputed
transpose plan; block values are graph data and get no gradient.

Wrappers: on a CPU tensor a kernel wrapper runs the plain version; on a
CUDA tensor it launches the kernel (built from ``csrc/bsr_spmm.cu`` at
first use) or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

BLOCK = 128
#: output columns per CUDA block in csrc/bsr_spmm.cu (BN); d must divide
D_TILE = 64
#: most blocks one CUDA block of bsr_spmm_blockpar multiplies (one chunk)
CHUNK = 8


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """BSR plan of one matrix (one direction).

    blocks:        f32[NB, 128, 128] dense blocks, sorted by row tile.
    block_col:     int32[NB] column-tile index per block.
    block_row:     int32[NB] row-tile index per block (non-decreasing).
    row_ptr:       int32[R+1] block range per row tile (padding blocks from
                   :func:`pad_block_plan` sit past ``row_ptr[-1]``).
    chunk_ptr:     int32[NC+1] block range per chunk: each row tile's run
                   of blocks (padding included) cut into pieces of at most
                   ``CHUNK`` blocks, in block order.
    row_chunk_ptr: int32[R+1] chunk range per row tile.
    n_rows / n_cols: padded (multiple of 128) output / input sizes.
    """

    blocks: torch.Tensor
    block_col: torch.Tensor
    block_row: torch.Tensor
    row_ptr: torch.Tensor
    chunk_ptr: torch.Tensor
    row_chunk_ptr: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def num_blocks(self) -> int:
        return int(self.blocks.shape[0])

    def to(self, device) -> "BlockPlan":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _chunks(block_row, r_tiles):
    """(chunk_ptr, row_chunk_ptr) for a non-decreasing ``block_row``."""
    counts = np.bincount(block_row, minlength=r_tiles).astype(np.int64)
    run_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    per_row = -(-counts // CHUNK)
    row_chunk_ptr = np.concatenate([[0], np.cumsum(per_row)])
    starts = np.repeat(run_start, per_row) + CHUNK * (
        np.arange(int(row_chunk_ptr[-1])) - np.repeat(row_chunk_ptr[:-1],
                                                      per_row))
    chunk_ptr = np.concatenate([starts, [len(block_row)]])
    return (torch.from_numpy(chunk_ptr.astype(np.int32)),
            torch.from_numpy(row_chunk_ptr.astype(np.int32)))


def _plan(blocks, block_col, block_row, row_ptr, n_rows, n_cols):
    chunk_ptr, row_chunk_ptr = _chunks(block_row, n_rows // BLOCK)
    return BlockPlan(blocks=torch.from_numpy(blocks),
                     block_col=torch.from_numpy(block_col),
                     block_row=torch.from_numpy(block_row),
                     row_ptr=torch.from_numpy(row_ptr),
                     chunk_ptr=chunk_ptr, row_chunk_ptr=row_chunk_ptr,
                     n_rows=int(n_rows), n_cols=int(n_cols))


def build_block_plan(mat, block=BLOCK) -> BlockPlan:
    """scipy sparse matrix -> BlockPlan (host tensors).

    Every row tile gets at least one block (a zero filler in column tile 0
    for a tile with no data), so the block-parallel kernel writes every
    output tile."""
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
    return _plan(blocks, u_ct, u_rt, row_ptr, n_rows, n_cols)


def build_block_plans(mat, block=BLOCK):
    """(forward_plan, transpose_plan) for the SpMM and its backward."""
    return build_block_plan(mat, block), build_block_plan(mat.T, block)


def pad_block_plan(plan: BlockPlan, nb: int) -> BlockPlan:
    """Pad the block bank of a host plan to ``nb`` blocks (the JAX
    package's way to give a window's plans one size; the port's windows
    keep each snapshot's own plan).  Padding blocks are zero, lie past
    ``row_ptr[-1]`` (the row-walk kernel never visits them) and repeat the
    last row tile (the block-parallel kernel adds zeros to that tile)."""
    cur = plan.num_blocks
    if cur > nb:
        raise ValueError(f"plan has {cur} blocks > pad target {nb}")
    if cur == nb:
        return plan
    pad = nb - cur
    blocks = np.concatenate(
        [plan.blocks.numpy(), np.zeros((pad, BLOCK, BLOCK), np.float32)])
    block_col = np.concatenate([plan.block_col.numpy(),
                                np.zeros(pad, np.int32)])
    block_row = np.concatenate([
        plan.block_row.numpy(),
        np.full(pad, int(plan.block_row[cur - 1]), np.int32)])
    return _plan(blocks, block_col, block_row, plan.row_ptr.numpy(),
                 plan.n_rows, plan.n_cols)


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
    return build_block_plan(stacked, block), build_block_plan(stacked.T, block)


# ---------------------------------------------------------------------------
# the kernels: plain versions and wrappers
# ---------------------------------------------------------------------------

def _check(plan: BlockPlan, x: torch.Tensor):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [n_cols, d] tensor")
    if x.shape[0] != plan.n_cols or x.shape[1] % D_TILE:
        raise ValueError(f"x is {tuple(x.shape)}; the plan takes "
                         f"[{plan.n_cols}, multiple of {D_TILE}]")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    for f in dataclasses.fields(plan):
        t = getattr(plan, f.name)
        if not isinstance(t, torch.Tensor):
            continue
        want = torch.float32 if f.name == "blocks" else torch.int32
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"plan.{f.name} must be a contiguous {want} "
                             f"tensor on {x.device}")
    # the kernels move x and out as float4
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def bsr_spmm_plain(plan: BlockPlan, x):
    """Plain version of both kernels, ``A @ x``: every row tile sums the
    products of the blocks in ``row_ptr[r] .. row_ptr[r+1]`` (padding
    blocks past ``row_ptr[-1]`` are zero and left out; the chunk plan is
    not used)."""
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


def bsr_spmm_rowwalk(plan: BlockPlan, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` by the row-walk kernel (counterpart of ``_spmm_kernel``,
    ``ctgcn_tpu/ops/pallas_spmm.py:97``).

    One CUDA block per (128-row output tile, 64-column d tile) walks its
    row's blocks, staging each block and x row tile through shared memory
    and accumulating in registers: deterministic, no scratch.  FP32 FFMA
    bound on the card (dense 128x128 blocks, 2*128*128*d FLOPs each).  A
    row tile's blocks run one after another on one SM, so a plan with few
    row tiles (the pyramid's transpose: Np/128 of them) fills few SMs.

    x: contiguous f32 [n_cols, d], d a multiple of 64 -> f32 [n_rows, d].
    """
    _check(plan, x)
    if x.device.type == "cpu":
        return bsr_spmm_plain(plan, x)
    from ctgcn_torch.ops.cuda_build import load_kernels

    lib = load_kernels()
    out = torch.empty(plan.n_rows, x.shape[1], device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bsr_spmm_rowwalk(
            plan.blocks.data_ptr(), plan.block_col.data_ptr(),
            plan.row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(),
            plan.n_rows // BLOCK, x.shape[1], _stream(x))
    _raise_on(rc, "bsr_spmm_rowwalk")
    bsr_spmm_rowwalk.launches += 1
    return out


bsr_spmm_rowwalk.launches = 0


def bsr_spmm_blockpar(plan: BlockPlan, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` by the block-parallel kernel (counterpart of
    ``_spmm_v2_kernel``, ``ctgcn_tpu/ops/pallas_spmm.py:146``).

    The TPU kernel carries the output tile across sequential grid steps;
    on Hopper nothing carries between CUDA blocks, so pass 1 gives each
    (chunk of at most ``CHUNK`` blocks of one row run, d tile) its own CUDA
    block writing a partial tile to scratch, and pass 2 sums each row
    tile's chunks in chunk order (deterministic, no atomics).  Row tiles
    with many blocks spread over many SMs.  FP32 FFMA bound like the
    row-walk kernel, plus scratch traffic of 2 * NC * 128 * d * 4 bytes.

    x: contiguous f32 [n_cols, d], d a multiple of 64 -> f32 [n_rows, d].
    """
    _check(plan, x)
    if x.device.type == "cpu":
        return bsr_spmm_plain(plan, x)
    from ctgcn_torch.ops.cuda_build import load_kernels

    lib = load_kernels()
    d = x.shape[1]
    n_chunks = plan.chunk_ptr.shape[0] - 1
    out = torch.empty(plan.n_rows, d, device=x.device)
    scratch = torch.empty(n_chunks * BLOCK, d, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bsr_spmm_blockpar(
            plan.blocks.data_ptr(), plan.block_col.data_ptr(),
            plan.chunk_ptr.data_ptr(), plan.row_chunk_ptr.data_ptr(),
            x.data_ptr(), scratch.data_ptr(), out.data_ptr(), n_chunks,
            plan.n_rows // BLOCK, d, _stream(x))
    _raise_on(rc, "bsr_spmm_blockpar")
    bsr_spmm_blockpar.launches += 1
    return out


bsr_spmm_blockpar.launches = 0

# Dispatch rule inherited from the TPU package (_V2_X_VMEM_BUDGET,
# pallas_spmm.py:173), where it sized x to stay resident in VMEM: x of at
# most 10 MB takes the block-parallel kernel, larger x the row walk.  Kept
# so each kernel runs where its TPU counterpart runs; to be re-derived from
# H100 timings.
BLOCKPAR_X_BYTES = 10 * 1024 * 1024


def block_spmm_raw(plan: BlockPlan, x: torch.Tensor) -> torch.Tensor:
    """x: [n_cols, d] (d a multiple of 64) -> [n_rows, d]."""
    if plan.n_cols * x.shape[1] * 4 <= BLOCKPAR_X_BYTES:
        return bsr_spmm_blockpar(plan, x)
    return bsr_spmm_rowwalk(plan, x)


class _BlockSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_p, fwd_plan, t_plan):
        ctx.t_plan = t_plan
        return block_spmm_raw(fwd_plan, x_p)

    @staticmethod
    def backward(ctx, g):
        return block_spmm_raw(ctx.t_plan, g.contiguous()), None, None


def block_spmm(fwd_plan: BlockPlan, t_plan: BlockPlan, x):
    """``A @ x`` with BSR plans, differentiable w.r.t. x.

    x: [n_cols_unpadded, d] -> [n_rows_padded, d].  Rows and the feature
    dim are zero-padded to multiples of 128 inside."""
    n_in, d = x.shape
    d_pad = -(-d // BLOCK) * BLOCK
    x_p = torch.nn.functional.pad(
        x.float(), (0, d_pad - d, 0, fwd_plan.n_cols - n_in)).contiguous()
    return _BlockSpmm.apply(x_p, fwd_plan, t_plan)[:, :d]


def pyramid_spmm(fwd_plan: BlockPlan, t_plan: BlockPlan, x, num_slots,
                 n_nodes):
    """All K slot products of a core pyramid: x [N, d] -> [K, N, d]."""
    out = block_spmm(fwd_plan, t_plan, x)
    return out.reshape(num_slots, fwd_plan.n_cols, -1)[:, :n_nodes, :]
