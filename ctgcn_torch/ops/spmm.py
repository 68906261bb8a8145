# coding: utf-8
"""Sparse-dense matmul of the model zoo (port of ``spmm``, ``spmm_t``,
``sddmm``, ``spmm_ev`` and ``set_default_backend`` in
``ctgcn_tpu/ops/spmm.py``).

``spmm(g, x)`` takes a graph's plan pair first (the CUDA kernels through
``ell_spmm``), then the backend asked for, else the default:

  * ``segment``: a gather of ``x[col] * val`` and ``index_add_`` into the
    rows (the JAX gather + ``segment_sum``), differentiable by autograd;
  * ``pallas``: ``spmm_pallas``, plans built for the call, on the kernels;
  * ``dense``: the densified matrix times x.

``spmm_ev`` is the segment form with edge values given apart from the
graph, differentiable in the values and in x (GAT's attention on graphs
without plans); ``sddmm`` is the per-edge ``<a[row], b[col]>`` (the
gradient in the values of ``ell_spmm_ev``).
"""
from __future__ import annotations

import torch

from ctgcn_torch.ops.bsr_spmm import build_csr_plan
from ctgcn_torch.ops.ell import ell_spmm
from ctgcn_torch.ops.sparse import SparseGraph, to_dense, to_scipy

BACKENDS = ("segment", "pallas", "dense")
_DEFAULT_BACKEND = "segment"


def set_default_backend(name: str):
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"spmm backend {name!r}, not one of {BACKENDS}")
    _DEFAULT_BACKEND = name


def spmm_ev(rows, cols, vals, x, n_rows):
    """``A(vals) @ x`` for the COO structure (rows, cols) and edge values
    ``vals``: a gather of ``x[col] * val`` and ``index_add_`` into the
    rows.  Autograd gives d(vals) as the SDDMM of the cotangent with x and
    d(x) as ``A^T`` times the cotangent."""
    out = x.new_zeros(n_rows, x.shape[1])
    return out.index_add_(0, rows, x[cols] * vals[:, None])


def sddmm(g: SparseGraph, a: torch.Tensor, b: torch.Tensor):
    """Sampled dense-dense matmul: ``<a[row], b[col]>`` for every edge of
    ``g``, in ``g``'s edge order -> [nnz]."""
    return (a[g.rows] * b[g.cols]).sum(-1)


def spmm(g: SparseGraph, x: torch.Tensor, backend: str | None = None):
    """``A @ x`` for ``g`` [N, M] and dense x [M, d]."""
    if backend is None and g.plan_fwd is not None:
        return ell_spmm(g.plan_fwd, g.plan_t, x)
    backend = backend or _DEFAULT_BACKEND
    if backend == "segment":
        return spmm_ev(g.rows, g.cols, g.vals, x, g.n_rows)
    if backend == "pallas":
        return spmm_pallas(g, x)
    if backend == "dense":
        return to_dense(g) @ x
    raise ValueError(f"unknown spmm backend {backend!r}")


def spmm_pallas(g: SparseGraph, x: torch.Tensor):
    """``A @ x`` on the kernels with plans built for this call (the JAX
    adapter of ``ctgcn_tpu/ops/pallas_spmm.py:259`` builds BSR plans; the
    kernels read only the CSR, so here ``build_csr_plan`` of the matrix and
    of its transpose).  Hot paths attach the plans to the graph once
    (``DataLoader.get_date_adj_list``)."""
    mat = to_scipy(g)
    return ell_spmm(build_csr_plan(mat).to(x.device),
                    build_csr_plan(mat.T).to(x.device), x)


def spmm_t(g: SparseGraph, x: torch.Tensor):
    """``A^T @ x`` without building the transpose."""
    if g.plan_t is not None:
        return ell_spmm(g.plan_t, g.plan_fwd, x)
    return spmm_ev(g.cols, g.rows, g.vals, x, g.n_cols)
