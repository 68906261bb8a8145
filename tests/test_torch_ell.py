# coding: utf-8
"""The ELL backend's plans and SpMM (``ctgcn_torch.ops.ell``) against
``ctgcn_tpu.ops.ell``.

The port keeps each slot matrix in CSR (a ``CsrPlan``) where the JAX
package keeps degree-bucketed tables, so the plans are compared as
matrices: the dense [K·N, N] (and [N, K·N]) that the JAX buckets and
``inv_perm`` rebuild must equal the port's CSR exactly.  ``ell_spmm`` runs
its kernels' plain version on these CPU tensors.  Tolerance: f32 values
1e-5, gradients 1e-4 (sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.ops import bsr_spmm as B
from ctgcn_torch.ops import ell as TE
from ctgcn_torch.ops import pyramid as TP
from ctgcn_torch.training import profiling
from ctgcn_tpu.ops import ell as JE
from ctgcn_tpu.ops import pyramid as JP

N, T, K = 40, 3, 4


def _window(seed=0):
    """T snapshots of nested weighted cores, max core first; snapshot 1
    repeats a core (dropped by the delta-skip), so each snapshot leaves
    trailing slots of the K = 4 invalid.  Node 0 is a hub."""
    rng = np.random.default_rng(seed)
    per_snap = []
    for t in range(T):
        dense = (rng.random((N, N)) < 0.15) * rng.integers(1, 6, (N, N))
        dense[0, 1:] = rng.integers(1, 3, N - 1)
        a = np.triu(dense, 1)
        a = (a + a.T).astype(np.float64)
        deg = (a != 0).sum(1)
        mats = [sp.csr_matrix(a * np.outer(deg >= k, deg >= k))
                for k in (8, 5, 1)]
        if t == 1:
            mats.insert(1, mats[0].copy())
        per_snap.append(mats)
    return per_snap


@pytest.fixture(scope="module")
def stacked():
    per_snap = _window()
    cap = max(m.nnz + N for mats in per_snap for m in mats)
    tpyr = TP.stack_pyramids([TP.build_core_pyramid(m, N, K)
                              for m in per_snap])
    jpyr = JP.stack_pyramids([JP.build_core_pyramid(m, N, K, pad_to=cap)
                              for m in per_snap])
    np.testing.assert_array_equal(tpyr.valid.numpy(), np.asarray(jpyr.valid))
    assert not tpyr.valid[:, -1].any()
    return tpyr, jpyr


def _jax_dense(plan, t):
    """Snapshot t of a stacked JAX EllPlan as a dense matrix: bucket rows
    in concatenation order, routed back by ``inv_perm``."""
    cat_rows = []
    for b in plan.buckets:
        cols = np.asarray(b.cols)[t].astype(np.int64)
        vals = np.asarray(b.vals)[t].astype(np.float32)
        for c, v in zip(cols, vals):
            row = np.zeros(plan.n_cols, np.float32)
            np.add.at(row, c, v)
            cat_rows.append(row)
    return np.stack(cat_rows)[np.asarray(plan.inv_perm)[t]]


def _csr_dense(plan):
    out = np.zeros((plan.n_rows, plan.n_cols), np.float32)
    rows = np.repeat(np.arange(plan.n_rows), np.diff(plan.csr_ptr.numpy()))
    out[rows, plan.csr_col.numpy()] = plan.csr_val.numpy()
    return out


@pytest.mark.parametrize("delta", [False, True], ids=["full", "delta"])
def test_plans_equal_jax_buckets(stacked, delta):
    tpyr, jpyr = stacked
    fwd, tr = TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals,
                                         tpyr.valid, N, delta=delta)
    jf, jt = JE.build_pyramid_ell_plans(jpyr.rows, jpyr.cols, jpyr.vals,
                                        jpyr.valid, N, delta=delta)
    for t in range(T):
        assert (fwd[t].n_rows, fwd[t].n_cols) == (K * N, N)
        assert (tr[t].n_rows, tr[t].n_cols) == (N, K * N)
        np.testing.assert_array_equal(_csr_dense(fwd[t]), _jax_dense(jf, t))
        np.testing.assert_array_equal(_csr_dense(tr[t]), _jax_dense(jt, t))
        np.testing.assert_array_equal(_csr_dense(tr[t]), _csr_dense(fwd[t]).T)


def test_delta_gathers_each_edge_once(stacked):
    """A delta plan holds each edge of the widest kept core once (slot 0
    without its +I); a full-slot plan holds it once per slot."""
    tpyr, _ = stacked
    fwd_d, _ = TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals,
                                          tpyr.valid, N, delta=True)
    fwd_f, _ = TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals,
                                          tpyr.valid, N, delta=False)
    for t, mats in enumerate(_window()):
        assert fwd_d[t].nnz == mats[-1].nnz < fwd_f[t].nnz


def test_delta_plans_need_prefix_validity(stacked):
    tpyr, _ = stacked
    valid = tpyr.valid.clone()
    valid[0, 0] = False
    with pytest.raises(ValueError, match="prefix validity"):
        TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals, valid, N,
                                   delta=True)


def test_forward_walk_order_groups_a_nodes_slots(stacked):
    """The forward plan's row walk takes a node's K slot rows side by
    side.  The hub's transpose row, the longest, holds each of its edges
    once in a delta plan and once per slot that holds it in a full-slot
    plan."""
    tpyr, _ = stacked
    fwd, tr = TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals,
                                         tpyr.valid, N, delta=True)
    nodes = fwd[0].row_order.numpy() % N
    np.testing.assert_array_equal(nodes.reshape(-1, K),
                                  np.repeat(nodes[::K], K).reshape(-1, K))
    assert tr[0].max_row_nnz == N - 1
    hub = TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals,
                                     tpyr.valid, N, delta=False)[1][0]
    assert hub.max_row_nnz > N - 1


def _powerlaw(rng, n=200, m=160):
    """Power-law rows with hubs, empty rows and duplicates (as the JAX
    package's ELL tests build them)."""
    deg = np.minimum((rng.pareto(1.0, n) * 3).astype(int), n - 1)
    deg[rng.random(n) < 0.1] = 0
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()


@pytest.mark.parametrize("d", [17, 24])
@pytest.mark.parametrize("matrix", ["powerlaw", "pyramid_delta"])
def test_ell_spmm_value_and_grad_equal_jax(stacked, matrix, d):
    """``ell_spmm`` and its gradient (through the transpose plan) against
    JAX ``ell_spmm`` and its custom VJP; d = 17 is padded to 20 inside."""
    rng = np.random.default_rng(4)
    if matrix == "powerlaw":
        m = _powerlaw(rng)
        fwd, tr = B.build_csr_plan(m), B.build_csr_plan(m.T)
        jf, jt = JE.build_ell_plans(m)
    else:
        tpyr, jpyr = stacked
        fwd, tr = (p[2] for p in TE.build_pyramid_ell_plans(
            tpyr.rows, tpyr.cols, tpyr.vals, tpyr.valid, N, delta=True))
        jf, jt = (jax.tree.map(lambda a: a[2], p)
                  for p in JE.build_pyramid_ell_plans(
                      jpyr.rows, jpyr.cols, jpyr.vals, jpyr.valid, N,
                      delta=True))
    x = rng.standard_normal((fwd.n_cols, d)).astype(np.float32)
    w = rng.standard_normal((fwd.n_rows, d)).astype(np.float32)

    def jloss(xx):
        return jnp.sum(jnp.sin(JE.ell_spmm(jf, jt, xx)) * w)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = TE.ell_spmm(fwd, tr, xt)
    assert out.shape == (fwd.n_rows, d)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(JE.ell_spmm(jf, jt, jnp.asarray(x))), rtol=1e-5,
        atol=1e-5)
    loss = (torch.sin(out) * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4)


def test_cpu_ell_spmm_counts_no_launch(stacked):
    """On CPU tensors the wrappers run the plain version and count no
    kernel launch."""
    tpyr, _ = stacked
    fwd, tr = TE.build_pyramid_ell_plans(tpyr.rows, tpyr.cols, tpyr.vals,
                                         tpyr.valid, N, delta=True)
    names = ("spmm.launches.bsr_spmm_rowwalk",
             "spmm.launches.bsr_spmm_blockpar")
    before = tuple(map(profiling.counter, names))
    x = torch.randn(N, 8, requires_grad=True)
    TE.ell_spmm(fwd[0], tr[0], x).sum().backward()
    assert tuple(map(profiling.counter, names)) == before
