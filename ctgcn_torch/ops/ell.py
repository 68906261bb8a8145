# coding: utf-8
"""The core pyramid's SpMM for large sparse graphs: per-snapshot slot
matrices, full-slot or delta-encoded, run on the CUDA CSR kernels (port of
``build_pyramid_ell_plans`` and ``ell_spmm`` in ``ctgcn_tpu/ops/ell.py``).

A snapshot's K core slots flatten to one block-diagonal [K·N, N] matrix,
slot k's rows at k·N, so all K slot products are one SpMM; its transpose
[N, K·N] carries the backward (dx = A^T g).  With ``delta=True`` the slots
hold Δ_k = A_k − A_{k−1} (slot 0 without its +I): k-core supports nest and
keep the original edge weights, so each edge is gathered once, at its
deepest slot, instead of once per slot that holds it.  ``CoreDiffusion``
then rebuilds the slot prefixes with two cumulative sums and adds the
identity back as "+ x".

The JAX package stores each matrix as degree-bucketed ELL tables
(``EllPlan``, ``_bucket_apply``, ``_soft_bucket``): a TPU scatters slowly,
so each bucket is a dense gather and row-sum, one permutation gather
restores row order, and bucket sizes are rounded so that windows share
compiled shapes.  On Hopper the CSR row walk is that scatter-free gather
and row-sum already (a warp sums its row in registers), and nothing is
compiled per shape, so the plans here are ``CsrPlan``s and no bucket table
is carried over.  ``ell_spmm(..., bf16=True)`` gathers x in bf16 and stores
the products in bf16 (the config's ``matmul_precision: "bf16"``), on the
kernels' bf16 instantiations.  They run on the two existing kernels through
``dispatch``: a forward plan (short rows) on ``bsr_spmm_rowwalk``, a
transpose with hub rows on ``bsr_spmm_blockpar``.  The forward plan's walk
order puts a node's K slot rows side by side, as the BSR pyramid plans do.
No plan builds 128x128 blocks: at 60k nodes that bank would be mostly
zeros.

``ell_spmm_ev`` (port of ``ell_spmm_ev`` and ``build_ell_ev_plans`` in
``ctgcn_tpu/ops/ell.py``) multiplies by edge values that change every
step, GAT's attention.  A zoo graph's plan pair are ``EvPlan``s: the
``CsrPlan`` of the graph that ``ell_spmm`` reads, which also names each
nonzero's edge id (the JAX package's ``eids`` in its ELL-ev buckets),
built once from ``edge id + 1`` over the structure, never from the
matrix's values.  Each call gathers the values into plan order and hands
them to the same two kernels in place of the plan's own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from torch.nn import functional as F

from ctgcn_torch.ops.bsr_spmm import (D_ALIGN, D_ALIGN_BF16, CsrPlan,
                                      _csr_fields, _kernel_input,
                                      build_csr_plan, csr_spmm, dispatch)
from ctgcn_torch.ops.sparse import SparseGraph


def _slot_matrix(rows, cols, vals, valid, n_nodes, delta):
    """One snapshot's [K, P] COO slots (+I in slot 0) -> scipy CSR
    [K·N, N] with slot k's rows at k·N; invalid slots give no rows."""
    K = rows.shape[0]
    val_mask = (vals != 0) & valid[:, None]
    if not delta:
        off = (np.arange(K) * n_nodes)[:, None]
        flat = ((rows + off)[val_mask], cols[val_mask], vals[val_mask])
    else:
        n_kept = int(valid.sum())
        if not valid[:n_kept].all():
            raise ValueError("delta plans need prefix validity")
        parts = [(np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros(0))]
        prev = None
        for k in range(n_kept):
            m = val_mask[k]
            cur = sp.coo_matrix((vals[k][m], (rows[k][m], cols[k][m])),
                                shape=(n_nodes, n_nodes)).tocsr()
            if k == 0:
                # slot 0 carries the +I; the model adds it back as "+ x"
                cur = cur - sp.eye(n_nodes, format="csr")
                cur.eliminate_zeros()
                delta_k = cur
            else:
                delta_k = cur - prev
                delta_k.eliminate_zeros()
            prev = cur
            dcoo = delta_k.tocoo()
            parts.append((dcoo.row + k * n_nodes, dcoo.col, dcoo.data))
        flat = tuple(np.concatenate(p) for p in zip(*parts))
    return sp.coo_matrix((flat[2], (flat[0], flat[1])),
                         shape=(K * n_nodes, n_nodes)).tocsr()


def build_pyramid_ell_plans(stacked_rows, stacked_cols, stacked_vals, valid,
                            n_nodes, delta=False):
    """A window's [T, K, P] COO slots -> (forward plans [K·N, N],
    transpose plans [N, K·N]), one ``CsrPlan`` per snapshot each, on the
    host.  Values are summed in float64 and stored as float32.

    ``delta``: slot k holds Δ_k = A_k − A_{k−1}, slot 0 without its +I,
    which needs validity to be a prefix (``build_core_pyramid`` compacts
    the kept slots, so it is)."""
    rows = np.asarray(stacked_rows).astype(np.int64)
    cols = np.asarray(stacked_cols).astype(np.int64)
    vals = np.asarray(stacked_vals).astype(np.float64)
    valid = np.asarray(valid).astype(bool)
    T, K, _ = rows.shape
    node_of_row = np.arange(K * n_nodes) % n_nodes
    fwd, tr = [], []
    for t in range(T):
        mat = _slot_matrix(rows[t], cols[t], vals[t], valid[t], n_nodes,
                           delta)
        fwd.append(build_csr_plan(mat, row_group=node_of_row))
        tr.append(build_csr_plan(mat.T))
    return tuple(fwd), tuple(tr)


class _CsrSpmmBf16(torch.autograd.Function):
    """The JAX custom VJP of ``ell_spmm(..., bf16=True)``: the forward
    gathers x in bf16 and returns bf16 products; the backward gathers the
    cotangent in bf16 and returns dx in f32 (``ctgcn_tpu/ops/ell.py:
    199-204``)."""

    @staticmethod
    def forward(ctx, x, fwd_plan, t_plan):
        ctx.t_plan = t_plan
        return dispatch(fwd_plan, bf16=True)(
            fwd_plan, x.bfloat16().contiguous(), torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        t_plan = ctx.t_plan
        dx = dispatch(t_plan, bf16=True)(
            t_plan, g.bfloat16().contiguous(), torch.float32)
        return dx, None, None


def ell_spmm(fwd_plan: CsrPlan, t_plan: CsrPlan, x, bf16=False):
    """``A @ x`` ([R, C] @ [C, d] -> [R, d]), differentiable in x through
    the transpose plan (the JAX custom VJP).  d is zero-padded inside to
    what the kernels take: a multiple of 4, or of 8 with ``bf16``.

    ``bf16``: x and the values are rounded to bf16, the products summed in
    f32 and returned in bf16; dx comes back in f32."""
    d = x.shape[1]
    pad = -d % (D_ALIGN_BF16 if bf16 else D_ALIGN)
    xp = F.pad(x, (0, pad)) if pad else x
    if bf16:
        out = _CsrSpmmBf16.apply(xp.float(), fwd_plan, t_plan)
    else:
        out = csr_spmm(fwd_plan, t_plan, xp)
    return out[:, :d] if pad else out


@dataclasses.dataclass(frozen=True)
class EvPlan(CsrPlan):
    """A ``CsrPlan`` of a graph (its values, for ``ell_spmm``) that also
    names each nonzero's edge, for edge values given per call
    (``ell_spmm_ev``).

    csr_eid:    int64[nnz] the edge id (position in the graph's COO) of
                each nonzero, in plan order.
    """

    csr_eid: torch.Tensor


def _ev_plan(rows, cols, vals, n_rows, n_cols) -> EvPlan:
    """``EvPlan`` (host tensors) of the COO edges (rows, cols, vals): the
    CSR of ``edge id + 1`` over the structure gives each nonzero's edge
    id, and the values follow it into plan order."""
    eids = sp.csr_matrix((np.arange(1, rows.shape[0] + 1), (rows, cols)),
                         shape=(n_rows, n_cols))
    eids.sort_indices()
    if eids.nnz != rows.shape[0]:
        raise ValueError("build_ev_plans: repeated (row, col) edges")
    eid = eids.data - 1
    r = np.repeat(np.arange(n_rows), np.diff(eids.indptr))
    return EvPlan(**_csr_fields(r, eids.indices, vals[eid], n_rows, None),
                  n_rows=n_rows, n_cols=n_cols,
                  csr_eid=torch.from_numpy(eid))


def build_ev_plans(g: SparseGraph):
    """(forward, transpose) ``EvPlan``s of a host graph with distinct
    edges and no zero values; both index the graph's edge order."""
    rows, cols, vals = (t.numpy() for t in (g.rows, g.cols, g.vals))
    return (_ev_plan(rows, cols, vals, g.n_rows, g.n_cols),
            _ev_plan(cols, rows, vals, g.n_cols, g.n_rows))


class _EllSpmmEv(torch.autograd.Function):
    """The JAX custom VJP of ``ell_spmm_ev`` (``_ev_fwd`` / ``_ev_bwd``):
    d(vals) is the SDDMM ``g[row] . x[col]`` in edge order, d(x) the
    transpose plan's product, each only when asked for."""

    @staticmethod
    def forward(ctx, vals, x, graph):
        ctx.graph = graph
        ctx.save_for_backward(vals, x)
        plan = graph.plan_fwd
        return dispatch(plan)(plan, x, vals[plan.csr_eid])

    @staticmethod
    def backward(ctx, g):
        # spmm.py imports this module
        from ctgcn_torch.ops.spmm import sddmm

        graph = ctx.graph
        vals, x = ctx.saved_tensors
        g = _kernel_input(g)
        dvals = dx = None
        if ctx.needs_input_grad[0]:
            dvals = sddmm(graph, g, x)
        if ctx.needs_input_grad[1]:
            plan = graph.plan_t
            dx = dispatch(plan)(plan, g, vals[plan.csr_eid])
        return dvals, dx, None


def ell_spmm_ev(graph: SparseGraph, vals, x):
    """``A(vals) @ x`` ([R, C] @ [C, d] -> [R, d]) on the kernels, for a
    graph that carries its ``EvPlan`` pair and f32 edge values ``vals``
    [nnz] in the graph's edge order; differentiable in vals and in x.
    The graph's own values are not read.  d is zero-padded inside to a
    multiple of 4."""
    if not isinstance(graph.plan_fwd, EvPlan):
        raise ValueError("ell_spmm_ev needs a graph with its EvPlan pair "
                         "(build_ev_plans)")
    d = x.shape[1]
    pad = -d % D_ALIGN
    xp = F.pad(x, (0, pad)) if pad else x
    out = _EllSpmmEv.apply(vals.float(), _kernel_input(xp), graph)
    return out[:, :d] if pad else out
