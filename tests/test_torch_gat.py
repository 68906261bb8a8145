# coding: utf-8
"""The zoo's GAT and TgGAT against ``ctgcn_tpu`` on the CPU.

  * ``sddmm`` and ``spmm_ev`` (forward, and the gradients in the values
    and in x) against the JAX functions, on a random graph with an
    isolated node and a hub (N = 70, numpy seeds).
  * ``ell_spmm_ev`` on the port's ``EvPlan`` pair (the kernels' plain
    versions here) against JAX ``ell_spmm_ev`` on ``build_ell_ev_plans``
    and against ``spmm_ev``, at widths 1 (GAT's row sum), 5 and 8.
  * ``SpGraphAttentionLayer`` and ``GAT`` (1 and 2 heads, identity and
    file features, segment and plan backends) from the JAX parameters
    (``params_from_numpy``), dropout off; the parity traps: the values of
    the adjacency are never read, TgGAT's isolated node is a zero row.
  * The driver's window and U-neg loss for GAT and TgGAT on the zoo's
    generated dataset (``tests/test_torch_zoo.py``), segment and "ell",
    and the CLI on both.

Forward within 1e-5 (rtol and atol); gradients within 1e-4 of the value
plus 1e-4 of the largest gradient (``_check_grads``), the zoo's tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.nn.gat import GAT as TGAT
from ctgcn_torch.nn.gat import SpGraphAttentionLayer as TLayer
from ctgcn_torch.ops import ell as TE
from ctgcn_torch.ops.bsr_spmm import (bsr_spmm_csr_plain, bsr_spmm_rowwalk,
                                      build_csr_plan)
from ctgcn_torch.ops import sparse as TS
from ctgcn_torch.ops import spmm as TSP
from ctgcn_tpu.nn.gat import GAT as JGAT
from ctgcn_tpu.nn.gat import SpGraphAttentionLayer as JLayer
from ctgcn_tpu.ops import ell as JE
from ctgcn_tpu.ops import sparse as JS
from ctgcn_tpu.ops.spmm import sddmm as jsddmm
from ctgcn_tpu.ops.spmm import spmm_ev as jspmm_ev
from tests.test_torch_zoo import (EMB, FWD_TOL, HID, N, T, _check_grads,
                                  _cli_run, _compare, _driver_window_and_loss,
                                  _features, _load, _windows,
                                  dataset)  # noqa: F401

NG = 70


def _graph(seed=0, hub=True):
    """A weighted symmetric random graph on NG nodes: node NG - 1
    isolated, node 0 (``hub``) linked to half the others."""
    rng = np.random.default_rng(seed)
    a = (rng.random((NG, NG)) < 0.06) * (rng.random((NG, NG)) + 0.1)
    if hub:
        a[0, 1:NG // 2] = 1.0
    a = np.triu(a, 1)
    a = a + a.T
    a[NG - 1] = a[:, NG - 1] = 0.0
    return sp.coo_matrix(a)


def _x(seed, d, n=NG):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _both(m):
    """(port graph with its EvPlan pair, JAX padded graph)."""
    g = TS.from_scipy(m)
    fwd, tr = TE.build_ev_plans(g)
    return (dataclasses.replace(g, plan_fwd=fwd, plan_t=tr),
            JS.from_scipy(m))


def test_sddmm_and_spmm_ev_equal_jax():
    tg, jg = _both(_graph())
    nnz = tg.nnz
    a, b = _x(1, 7), _x(2, 7)
    np.testing.assert_allclose(
        TSP.sddmm(tg, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jsddmm(jg, jnp.asarray(a), jnp.asarray(b)))[:nnz],
        rtol=FWD_TOL, atol=FWD_TOL)

    vals = np.random.default_rng(3).random(nnz).astype(np.float32) + 0.1
    x, w = _x(4, 5), _x(5, 5)
    jvals = jnp.zeros(jg.capacity).at[:nnz].set(vals)

    def jloss(v, xx):
        out = jspmm_ev(jg.rows, jg.cols, v, xx, NG)
        return jnp.sum(out * w), out

    (_, jout), (jdv, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jvals, jnp.asarray(x))
    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out = TSP.spmm_ev(tg.rows, tg.cols, tv, tx, NG)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv)[:nnz],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert not out[NG - 1].any()


def test_ev_plans_name_each_edge():
    """Each plan's nonzero k carries edge ``csr_eid[k]``: the forward plan
    walks the graph's (row, col) order, the transpose plan the edges
    swapped; both hold the graph's values in plan order, so each is the
    plan that ``build_csr_plan`` makes of the matrix (or its
    transpose)."""
    m = _graph()
    tg, _ = _both(m)
    fwd, tr = tg.plan_fwd, tg.plan_t
    for plan, r, c, mat in ((fwd, tg.rows, tg.cols, m),
                            (tr, tg.cols, tg.rows, m.T)):
        eid = plan.csr_eid
        assert sorted(eid.tolist()) == list(range(tg.nnz))
        torch.testing.assert_close(plan.csr_row.long(), r[eid])
        torch.testing.assert_close(plan.csr_col.long(), c[eid])
        torch.testing.assert_close(plan.csr_val, tg.vals[eid])
        want = build_csr_plan(mat)
        for name in ("csr_ptr", "csr_col", "csr_row", "csr_val",
                     "row_order"):
            torch.testing.assert_close(getattr(plan, name),
                                       getattr(want, name), rtol=0, atol=0)
        assert plan.max_row_nnz == want.max_row_nnz
    assert fwd.max_row_nnz == int(torch.bincount(tg.rows).max()) >= NG // 2 - 1
    with pytest.raises(ValueError, match="repeated"):
        TE.build_ev_plans(TS.SparseGraph(
            rows=torch.tensor([1, 1]), cols=torch.tensor([2, 2]),
            vals=torch.ones(2), n_rows=4, n_cols=4))
    # a graph whose plans name no edges cannot take values per call
    plain = build_csr_plan(m)
    with pytest.raises(ValueError, match="EvPlan"):
        TE.ell_spmm_ev(dataclasses.replace(tg, plan_fwd=plain, plan_t=plain),
                       torch.ones(tg.nnz), torch.ones(NG, 4))
    # the wrappers take values in plan order, one f32 a nonzero
    x = torch.ones(NG, 4)
    for bad in (torch.ones(tg.nnz - 1), torch.ones(tg.nnz).double()):
        with pytest.raises(ValueError, match="vals"):
            bsr_spmm_rowwalk(fwd, x, bad)


@pytest.mark.parametrize("d", [1, 5, 8])
def test_ell_spmm_ev_equal_jax(d):
    """Forward, d(vals) and d(x) of ``ell_spmm_ev`` against JAX's on its
    ELL-ev plans and against the segment ``spmm_ev``."""
    m = _graph(6)
    tg, jg = _both(m)
    nnz = tg.nnz
    jf, jt = JE.build_ell_ev_plans(np.asarray(jg.rows), np.asarray(jg.cols),
                                   np.asarray(jg.vals) != 0, NG, NG)
    vals = np.random.default_rng(7).random(nnz).astype(np.float32) + 0.1
    x, w = _x(8, d), _x(9, d)
    jvals = jnp.zeros(jg.capacity).at[:nnz].set(vals)

    def jloss(v, xx):
        out = JE.ell_spmm_ev(jf, jt, v, xx)
        return jnp.sum(out * w), out

    (_, jout), (jdv, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jvals, jnp.asarray(x))
    got = {}
    for name, fn in (
            ("ell", lambda v, xx: TE.ell_spmm_ev(tg, v, xx)),
            ("segment", lambda v, xx: TSP.spmm_ev(tg.rows, tg.cols, v, xx,
                                                  NG))):
        tv = torch.from_numpy(vals).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        out = fn(tv, tx)
        (out * torch.from_numpy(w)).sum().backward()
        got[name] = (out.detach(), tv.grad, tx.grad)
        for t_arr, j_arr in ((out.detach(), jout), (tv.grad, jdv[:nnz]),
                             (tx.grad, jdx)):
            np.testing.assert_allclose(t_arr.numpy(), np.asarray(j_arr),
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=name)
    for a, b in zip(got["ell"], got["segment"]):
        torch.testing.assert_close(a, b, rtol=FWD_TOL, atol=FWD_TOL)


def test_ell_spmm_ev_skips_dx_without_grad(monkeypatch):
    """A ones column (GAT's row sum) needs no d(x): the backward computes
    d(vals) and runs no product on the transpose plan."""
    tg, _ = _both(_graph())
    dispatched = []

    def recording(plan):
        dispatched.append(plan)
        return bsr_spmm_csr_plain

    monkeypatch.setattr(TE, "dispatch", recording)
    vals = torch.rand(tg.nnz, generator=torch.Generator().manual_seed(0),
                      requires_grad=True)
    out = TE.ell_spmm_ev(tg, vals, torch.ones(NG, 1))
    assert out.shape == (NG, 1)
    out.sum().backward()
    assert dispatched == [tg.plan_fwd]
    torch.testing.assert_close(vals.grad, torch.ones(tg.nnz))


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_attention_layer_equal_jax(concat, backend):
    tg, jg = _both(_graph(10))
    if backend == "segment":
        tg = dataclasses.replace(tg, plan_fwd=None, plan_t=None)
    else:
        jf, jt = JE.build_ell_ev_plans(
            np.asarray(jg.rows), np.asarray(jg.cols),
            np.asarray(jg.vals) != 0, NG, NG)
        jg = jg.replace(ell_ev_fwd=jf, ell_ev_t=jt)
    x, w = _x(11, 9), _x(12, 6)
    jl = JLayer.init(jax.random.key(3), 9, 6, dropout=0.5, alpha=0.2,
                     concat=concat)
    tl = _load(TLayer(9, 6, 0.5, 0.2, concat=concat), jl)

    def jloss(m):
        out = m(jnp.asarray(x), jg)
        return jnp.sum(jnp.tanh(out) * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jl)
    out = tl(torch.from_numpy(x), tg)
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(tl, jgrads)
    # the isolated node: no edge, so a zero row
    assert not out[NG - 1].any()


@pytest.mark.parametrize("adj_backend", ["segment", "ell"])
@pytest.mark.parametrize("features", [False, True],
                         ids=["identity", "features"])
@pytest.mark.parametrize("heads", [1, 2])
def test_gat_forward_and_grads_equal_jax(dataset, heads, features,
                                         adj_backend):
    """GAT on the zoo's window (D^-1 (A + I), as the driver gives it),
    dropout off, U-neg's log_softmax."""
    tgraphs, jwin = _windows(dataset, True, True, adj_backend)
    assert isinstance(tgraphs[0].plan_fwd, TE.EvPlan) is (
        adj_backend == "ell")
    assert (jwin.ell_ev_fwd is not None) is (adj_backend == "ell")
    in_dim, jxs, txs = _features(features)
    jmodel = JGAT.init(jax.random.key(4), in_dim, HID, EMB, dropout=0.5,
                       alpha=0.2, head_num=heads)
    tmodel = _load(TGAT(in_dim, HID, EMB, dropout=0.5, head_num=heads),
                   jmodel)
    _compare(jmodel, tmodel, lambda m: m(jxs, jwin),
             lambda m: m(txs, tgraphs))


def test_gat_reads_only_the_structure(dataset):
    """Scaling the adjacency's values, or replacing them, leaves GAT's
    output as it was, bit for bit."""
    tgraphs, _ = _windows(dataset, True, True, "segment")
    model = TGAT(N, HID, EMB, dropout=0.5, head_num=2,
                 generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        ref = model(None, tgraphs)
        for change in (lambda v: v * 3.0,
                       lambda v: torch.rand(v.shape, generator=gen) + 0.5):
            other = tuple(dataclasses.replace(g, vals=change(g.vals))
                          for g in tgraphs)
            assert torch.equal(model(None, other), ref)


@pytest.mark.parametrize("adj_backend", ["segment", "ell"])
def test_tggat_isolated_node_is_a_zero_row(dataset, adj_backend):
    """TgGAT's raw A gives node u119 (no edge, no self-loop) a zero row
    sum: every head's output row is zero, so its log_softmax row is
    log(1 / EMB) in every column, in both packages."""
    tgraphs, jwin = _windows(dataset, False, False, adj_backend)
    jmodel = JGAT.init(jax.random.key(5), N, HID, EMB, dropout=0.0,
                       alpha=0.2, head_num=1)
    tmodel = _load(TGAT(N, HID, EMB, dropout=0.0, head_num=1), jmodel)
    with torch.no_grad():
        heads = tmodel.attentions[0](None, tgraphs[0])
        out = tmodel(None, tgraphs)
    assert not heads[N - 1].any()
    want = np.full((T, EMB), -np.log(EMB), np.float32)
    np.testing.assert_allclose(out[:, N - 1].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jmodel(None, jwin))[:, N - 1],
                               want, rtol=1e-6)


@pytest.mark.parametrize("method, change", [
    ("GAT", {}), ("GAT", {"adj_backend": "ell"}),
    ("TgGAT", {}), ("TgGAT", {"adj_backend": "ell"})],
    ids=["GAT", "GAT-ell", "TgGAT", "TgGAT-ell"])
def test_driver_window_and_loss_equal_jax(dataset, method, change):
    """Both drivers' inputs, models and U-neg loss for one window, dropout
    0: GAT on D^-1 (A + I), TgGAT on the raw A, each with the EvPlan pair
    under "ell"."""
    _driver_window_and_loss(dataset, method, change)


@pytest.mark.parametrize("method", ["GAT", "TgGAT"])
def test_cli_runs_each_method(dataset, tmp_path, method):
    """``--task=embedding`` as configs/uci.json gives it, at test width,
    one epoch on the CPU: finite losses, one CSV per snapshot."""
    _cli_run(dataset, tmp_path, method)
