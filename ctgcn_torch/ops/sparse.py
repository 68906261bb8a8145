# coding: utf-8
"""Sparse graph container of the model zoo (port of
``ctgcn_tpu/ops/sparse.py``).

A graph is COO ``rows``/``cols``/``vals`` sorted by (row, col).  The JAX
package pads them to a power-of-two capacity so that XLA traces one shape
for every snapshot; nothing is traced here, so a graph keeps its exact
nonzeros.  In place of the JAX package's degree-bucketed ELL tables a graph
may carry a pair of ``CsrPlan``s (forward and transpose): ``spmm`` then
runs the CUDA kernels through ``ell_spmm`` (``ops/ell.py``).  The loader's
plans are ``EvPlan``s, which also name each nonzero's edge, so that
``ell_spmm_ev`` runs the kernels with edge values computed every step
(GAT's attention; the JAX package's ``ell_ev_fwd`` / ``ell_ev_t``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.ops.bsr_spmm import CsrPlan


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """COO sparse matrix [n_rows, n_cols].

    rows, cols:     int64[nnz], sorted by (row, col).
    vals:           float32[nnz], no zeros.
    plan_fwd:       optional ``CsrPlan`` of the matrix ...
    plan_t:         ... and of its transpose: ``spmm`` prefers them.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int
    plan_fwd: CsrPlan | None = None
    plan_t: CsrPlan | None = None

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def backend(self) -> str:
        """"ell" when the graph carries its plans, else "segment"."""
        return "segment" if self.plan_fwd is None else "ell"

    def to(self, device) -> "SparseGraph":
        """The graph (and its plans) on ``device``."""
        return dataclasses.replace(
            self, rows=self.rows.to(device), cols=self.cols.to(device),
            vals=self.vals.to(device),
            plan_fwd=None if self.plan_fwd is None
            else self.plan_fwd.to(device),
            plan_t=None if self.plan_t is None else self.plan_t.to(device))


def from_coo(rows, cols, vals, shape):
    """SparseGraph from host COO arrays, sorted by (row, col)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    order = np.lexsort((cols, rows))
    return SparseGraph(rows=torch.from_numpy(rows[order]),
                       cols=torch.from_numpy(cols[order]),
                       vals=torch.from_numpy(vals[order]),
                       n_rows=int(shape[0]), n_cols=int(shape[1]))


def from_scipy(mat):
    """SparseGraph from any scipy sparse matrix; explicit zeros dropped."""
    coo = mat.tocoo()
    keep = coo.data != 0
    return from_coo(coo.row[keep], coo.col[keep], coo.data[keep], coo.shape)


def to_scipy(g: SparseGraph):
    """The graph as a scipy COO matrix (on the host)."""
    return sp.coo_matrix((g.vals.cpu().numpy(), (g.rows.cpu().numpy(),
                                                 g.cols.cpu().numpy())),
                         shape=g.shape)


def to_dense(g: SparseGraph) -> torch.Tensor:
    """Dense [n_rows, n_cols] (testing and small graphs only)."""
    out = g.vals.new_zeros(g.shape)
    return out.index_put_((g.rows, g.cols), g.vals, accumulate=True)


def eye(n) -> SparseGraph:
    idx = np.arange(n)
    return from_coo(idx, idx, np.ones(n, np.float32), (n, n))


def normalize_scipy_adj(adj, row_norm=False):
    """D^-1 A (``row_norm``) or D^-1/2 A D^-1/2 of a scipy matrix, as COO;
    rows of zero degree stay zero (the JAX package's
    ``normalize_scipy_adj``)."""
    adj = adj.tocsr()
    rowsum = np.asarray(adj.sum(axis=1)).flatten()
    p = -1.0 if row_norm else -0.5
    with np.errstate(divide="ignore"):
        r_inv = np.power(rowsum, p)
    r_inv[~np.isfinite(r_inv)] = 0.0
    r_mat_inv = sp.diags(r_inv)
    adj = r_mat_inv.dot(adj)
    if not row_norm:
        adj = adj.dot(r_mat_inv)
    return adj.tocoo()
