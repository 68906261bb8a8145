# coding: utf-8
"""CorePyramid: a snapshot's k-core adjacency hierarchy and the backends
its slot products run on (port of ``ctgcn_tpu/ops/pyramid.py``).

Per snapshot the k-core matrices come max core first; I is added to the
first (max-core) matrix only, and a core whose delta against the previous
kept core is empty is dropped.  Here the pyramid is a fixed bank of K core
slots whose dropped or absent slots are marked invalid by ``valid``: a
masked slot neither extends the diffusion prefix sum nor advances the
core-axis RNN, which equals dropping it.  The slot products run on one of
five backends, read in this order by ``CorePyramid.backend``:

  blocks   core-sorted leading principal blocks (dense, one matmul a slot);
  dense    the [K, N, N] bank (one batched matmul);
  ell      per-snapshot CSR plans of the [K·N, N] slot matrix, full-slot
           or delta-encoded, on the CUDA kernels (``ops/ell.py``);
  pallas   BSR plans of the same matrix (``ops/bsr_spmm.py``);
  segment  the padded [K, P] COO, a gather and an ``index_add``.

``uniform_blocks`` (window-uniform blocks for the mesh path) is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.ops.bsr_spmm import CsrPlan, build_pyramid_plans
from ctgcn_torch.ops.ell import build_pyramid_ell_plans
from ctgcn_torch.utils import pad_bucket


@dataclasses.dataclass(frozen=True)
class CorePyramid:
    """One snapshot, or a stacked window (a leading [T] axis on every
    tensor, a tuple of T entries for every per-snapshot object).

    valid:        bool[K] (window: [T, K]).
    n_nodes:      N.
    rows/cols/vals: [K, P] padded COO per slot, +I in slot 0 (segment).
    dense:        f32[K, N, N] (dense).
    blocks:       tuple over the kept slots of f32[nb_k, nb_k]: slot k's
                  leading principal block in core-sorted node order,
                  without the +I, nb_k a multiple of 256 (or N); a window
                  keeps each snapshot's own tuple (blocks).
    perm/inv_perm: int64[N] core-sorted node order and its inverse.
    plan_fwd/plan_t: BlockPlans [K·Np, Np] and transpose (pallas).
    ell_fwd/ell_t: CsrPlans [K·N, N] and transpose (ell), delta-encoded
                  when ``ell_delta``; ``ell_bf16`` gathers x in bf16 and
                  stores the slot products in bf16 (the config's
                  ``matmul_precision: "bf16"``).
    dense_prec:   "highest" or "high" (3xTF32 on the card) for the GEMMs
                  of an f32 dense bank or f32 blocks; a bf16 bank or bf16
                  blocks run bf16 operands with f32 results.
    """

    valid: torch.Tensor
    n_nodes: int
    rows: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    vals: torch.Tensor | None = None
    dense: torch.Tensor | None = None
    blocks: tuple | None = None
    perm: torch.Tensor | None = None
    inv_perm: torch.Tensor | None = None
    plan_fwd: CsrPlan | tuple | None = None
    plan_t: CsrPlan | tuple | None = None
    ell_fwd: CsrPlan | tuple | None = None
    ell_t: CsrPlan | tuple | None = None
    ell_delta: bool = False
    ell_bf16: bool = False
    dense_prec: str = "highest"

    @property
    def num_slots(self) -> int:
        return int(self.valid.shape[-1])

    @property
    def backend(self) -> str:
        """The backend the slot products run on (the first one present,
        in the JAX package's order)."""
        for name, field in (("blocks", self.blocks), ("dense", self.dense),
                            ("ell", self.ell_fwd), ("pallas", self.plan_fwd),
                            ("segment", self.rows)):
            if field is not None:
                return name
        raise ValueError("the pyramid carries no backend")

    def to(self, device) -> "CorePyramid":
        """Every tensor and plan on ``device`` (BlockPlans without their
        dense blocks, which no kernel reads)."""
        def move(v):
            if isinstance(v, tuple):
                return tuple(move(u) for u in v)
            if isinstance(v, (torch.Tensor, CsrPlan)):
                return v.to(device)
            return v

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def build_core_pyramid(core_mats, n_nodes, num_slots, densify=False,
                       build_blocks=False, build_plans=False,
                       dense_dtype=None, dense_prec="highest"):
    """Host CorePyramid from scipy matrices ordered max core first (the
    caller truncates to ``max_core`` and reverses): I is added to slot 0,
    and a core equal to the previous one is dropped.  The padded COO is
    always built; the other backends on request.

    Args:
      num_slots: fixed K (>= number of kept cores).
      build_blocks: core-sorted principal blocks, left out (None) when the
        slot supports do not nest.
      dense_dtype: dtype of the dense bank and of the blocks (default f32;
        ``torch.bfloat16`` for the config's ``matmul_precision: "bf16"``).
      dense_prec: "highest" or "high", the GEMM precision of an f32 bank.
    """
    kept, kept_raw = [], []
    prev = None
    for j, mat in enumerate(core_mats):
        mat = mat.tocsr()
        if j == 0:
            kept.append(mat + sp.eye(n_nodes, format="csr"))
            kept_raw.append(mat)
        elif abs(mat - prev).sum() != 0:
            kept.append(mat)
            kept_raw.append(mat)
        prev = mat

    K = int(num_slots)
    if len(kept) > K:
        raise ValueError(f"{len(kept)} kept cores > {K} slots")
    # COO capacity: a power-of-two bucket over the largest slot
    # (stack_pyramids pads a window to its largest)
    P = pad_bucket(max((m.nnz for m in kept), default=1), 256)
    rows = np.zeros((K, P), np.int64)
    cols = np.zeros((K, P), np.int64)
    vals = np.zeros((K, P), np.float32)
    valid = np.zeros((K,), bool)
    for k, m in enumerate(kept):
        coo = m.tocoo()
        keep = coo.data != 0
        r, c, v = coo.row[keep], coo.col[keep], coo.data[keep]
        order = np.lexsort((c, r))
        nnz = r.shape[0]
        rows[k, :nnz] = r[order]
        cols[k, :nnz] = c[order]
        vals[k, :nnz] = v[order]
        valid[k] = True
    rows_t, cols_t, vals_t = map(torch.from_numpy, (rows, cols, vals))

    dense = None
    if densify:
        dense = torch.zeros(K, n_nodes, n_nodes)
        dense.index_put_((torch.arange(K)[:, None].expand(K, P), rows_t,
                          cols_t), vals_t, accumulate=True)
        dense = dense.to(dense_dtype or torch.float32)
    plan_fwd = plan_t = None
    if build_plans:
        plan_fwd, plan_t = build_pyramid_plans(list(enumerate(kept)),
                                               n_nodes, K)
    blocks = perm = inv_perm = None
    if build_blocks:
        built = _build_core_blocks(kept_raw, n_nodes,
                                   dtype=dense_dtype or torch.float32)
        if built is not None:
            blocks, perm, inv_perm = built
    return CorePyramid(valid=torch.from_numpy(valid), n_nodes=int(n_nodes),
                       rows=rows_t, cols=cols_t, vals=vals_t, dense=dense,
                       blocks=blocks, perm=perm, inv_perm=inv_perm,
                       plan_fwd=plan_fwd, plan_t=plan_t,
                       dense_prec=dense_prec)


def _build_core_blocks(kept_raw, n_nodes, dtype=torch.float32, bucket=256):
    """Core-sorted leading-principal blocks of the kept slots (without
    the +I, which the model adds as "+ x").

    K-core supports nest (max core first: support(slot k) ⊆ support(slot
    k+1)), so with nodes sorted by the number of slots that hold them,
    descending (a stable sort), slot k's adjacency is the leading
    n_k x n_k block of the permuted matrix.  Returns (blocks, perm,
    inv_perm), each block of ``dtype`` padded with zeros to a multiple of
    ``bucket`` (at most N), or None when the supports do not nest."""
    level = np.zeros(n_nodes, np.int64)
    supports = []
    for m in kept_raw:
        coo = m.tocoo()
        nz = coo.data != 0
        s = np.zeros(n_nodes, bool)
        s[coo.row[nz]] = True
        s[coo.col[nz]] = True
        supports.append(s)
        level += s
    for a, b in zip(supports[:-1], supports[1:]):
        if np.any(a & ~b):
            return None
    perm = np.argsort(-level, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_nodes)
    blocks = []
    for m, s in zip(kept_raw, supports):
        nb = min(-(-max(int(s.sum()), 1) // bucket) * bucket, n_nodes)
        coo = m.tocoo()
        nz = coo.data != 0
        r, c = inv[coo.row[nz]], inv[coo.col[nz]]
        if r.size and (r.max() >= nb or c.max() >= nb):
            return None
        blk = np.zeros((nb, nb), np.float32)
        blk[r, c] = coo.data[nz]
        blocks.append(torch.from_numpy(blk).to(dtype))
    return tuple(blocks), torch.from_numpy(perm), torch.from_numpy(inv)


def stack_pyramids(pyramids):
    """Stack host per-snapshot pyramids (same K) into a window: tensors
    gain a leading [T] axis (the COO padded to the window's largest
    capacity), and blocks and plans become tuples of each snapshot's own.
    The JAX package pads BSR plans to one block count to stack them; a
    tuple needs no shared shape, so no padding blocks are made or
    multiplied."""
    first = pyramids[0]
    out = {}
    for f in dataclasses.fields(CorePyramid):
        vs = [getattr(p, f.name) for p in pyramids]
        if f.name in ("n_nodes", "ell_delta", "ell_bf16", "dense_prec"):
            out[f.name] = getattr(first, f.name)
        elif vs[0] is None:
            out[f.name] = None
        elif isinstance(vs[0], torch.Tensor):
            if f.name in ("rows", "cols", "vals"):
                cap = max(v.shape[1] for v in vs)
                vs = [torch.nn.functional.pad(v, (0, cap - v.shape[1]))
                      for v in vs]
            out[f.name] = torch.stack(vs)
        else:
            out[f.name] = tuple(vs)
    return CorePyramid(**out)


def pyramid_at(stacked: CorePyramid, t: int) -> CorePyramid:
    """Snapshot ``t`` of a stacked window."""
    return dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[t]
        for f in dataclasses.fields(stacked)
        if isinstance(getattr(stacked, f.name), (torch.Tensor, tuple))})


def attach_ell_plans(stacked: CorePyramid, delta=True,
                     bf16=False) -> CorePyramid:
    """A stacked window with per-snapshot CSR plans of its [K·N, N] slot
    matrices and their transposes (``ops/ell.py``), built from its COO.

    ``delta`` (default): delta-encode the nested core slots, so each edge
    is gathered once instead of once per slot that holds it.  ``bf16``:
    the slot products gather x in bf16 and are stored in bf16."""
    fwd, t = build_pyramid_ell_plans(stacked.rows, stacked.cols,
                                     stacked.vals, stacked.valid,
                                     stacked.n_nodes, delta=delta)
    return dataclasses.replace(stacked, ell_fwd=fwd, ell_t=t,
                               ell_delta=delta, ell_bf16=bf16)
