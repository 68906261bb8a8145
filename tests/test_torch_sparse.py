# coding: utf-8
"""The zoo's sparse pieces against ``ctgcn_tpu`` on the CPU: the
``SparseGraph`` container, ``normalize_scipy_adj``, ``spmm`` / ``spmm_t``
on every backend (the JAX ``"pallas"`` adapter runs its kernels in
interpret mode), the neighbor table and ``masked_max_pool``, and the
loader's ``get_date_adj_list`` under each ``adj_backend``.  Graphs are
random (numpy seeds), N <= 90.

Tolerance: host arrays exact; products, pooling and their gradients
within 1e-5 (f32 sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.ops import neighbors as TN
from ctgcn_torch.ops import sparse as TS
from ctgcn_torch.ops import spmm as TSP
from ctgcn_tpu.data.loader import DataLoader as JDataLoader
from ctgcn_tpu.ops import neighbors as JN
from ctgcn_tpu.ops import sparse as JS
from ctgcn_tpu.ops.spmm import spmm as jspmm, spmm_t as jspmm_t
from ctgcn_tpu.ops.pallas_spmm import block_spmm, build_block_plans

TOL = 1e-5
N, D = 90, 6


def _graph(seed, n=N, density=0.05, zero_row=True):
    """A weighted random matrix with an explicit zero, a duplicate entry
    and (``zero_row``) an empty row 3."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng,
                  format="coo", dtype=np.float64)
    rows = np.concatenate([a.row, [5, 7, 7]])
    cols = np.concatenate([a.col, [9, 2, 2]])
    vals = np.concatenate([a.data + 0.5, [0.0, 1.5, 0.25]])
    if zero_row:
        vals[rows == 3] = 0.0
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n))


def _x(seed, n=N, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def test_from_scipy_round_trip():
    m = _graph(0)
    tg, jg = TS.from_scipy(m), JS.from_scipy(m)
    # the same sorted nonzeros (the JAX graph pads them)
    nnz = tg.nnz
    assert nnz == int((m.data != 0).sum())
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name))[:nnz])
    dense = m.toarray().astype(np.float32)
    np.testing.assert_allclose(TS.to_dense(tg).numpy(), dense, atol=1e-7)
    np.testing.assert_array_equal(TS.to_dense(tg).numpy(),
                                  np.asarray(JS.to_dense(jg)))
    back = TS.to_scipy(tg)
    np.testing.assert_allclose(back.toarray(), dense, atol=1e-7)
    assert back.nnz == nnz
    np.testing.assert_array_equal(TS.to_dense(TS.eye(7)).numpy(), np.eye(7))


@pytest.mark.parametrize("row_norm", [False, True])
def test_normalize_equals_jax(row_norm):
    m = _graph(1) + _graph(2).T          # row 3 keeps only _graph(2)'s
    m = sp.lil_matrix(m)
    m[4, :] = 0.0                        # one row of zero degree
    m = sp.csr_matrix(m)
    got = TS.normalize_scipy_adj(m, row_norm=row_norm)
    ref = JS.normalize_scipy_adj(m, row_norm=row_norm)
    np.testing.assert_array_equal(got.toarray(), ref.toarray())
    assert not got.toarray()[4].any()


def _jax_pallas(g, x):
    """The JAX ``spmm_pallas`` adapter, its kernels in interpret mode."""
    fwd, t = build_block_plans(JS.to_scipy(g))
    return block_spmm(fwd, t, x, interpret=True)[:g.n_rows]


def _jax_spmm(backend, op):
    if op == "spmm_t":
        return jspmm_t
    if backend == "pallas":
        return _jax_pallas
    return lambda g, x: jspmm(g, x, backend=backend)


@pytest.mark.parametrize("op", ["spmm", "spmm_t"])
@pytest.mark.parametrize("backend", ["segment", "dense", "pallas"])
def test_spmm_and_grads_equal_jax(backend, op):
    """A @ x (A^T @ x) and d(sum(tanh(out) * w))/dx."""
    m = _graph(3)
    x, w = _x(4), _x(5)
    jg = JS.from_scipy(m)
    jfn = _jax_spmm(backend, op)

    def jloss(xx):
        return jnp.sum(jnp.tanh(jfn(jg, xx)) * w)

    jout = np.asarray(jfn(jg, jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tg = TS.from_scipy(m)
    xt = torch.from_numpy(x).requires_grad_()
    out = (TSP.spmm(tg, xt, backend=backend) if op == "spmm"
           else TSP.spmm_t(tg, xt))
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=TOL, atol=TOL)


def test_unknown_spmm_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        TSP.set_default_backend("scatter")
    with pytest.raises(ValueError, match="backend"):
        TSP.spmm(TS.eye(3), torch.ones(3, 1), backend="scatter")


def test_neighbor_table_equals_jax():
    mats = [_graph(s, zero_row=s == 6) for s in (6, 7)]
    mats = [(m + m.T).tocoo() for m in mats]
    got_n, got_d = TN.neighbor_table_from_scipy(mats)
    ref_n, ref_d = JN.neighbor_table_from_scipy(mats)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))


def test_masked_max_pool_and_grad_equal_jax():
    """Isolated nodes pool to zero rows; ReLU'd features make ties, whose
    gradient both split evenly."""
    m = _graph(8, density=0.01)
    m = (m + m.T).tocoo()
    nbr, deg = JN.neighbor_table_from_scipy([m])
    assert int((np.asarray(deg[0]) == 0).sum()) > 0
    x = np.maximum(_x(9), 0.0)
    w = _x(10)

    def jloss(xx):
        return jnp.sum(JN.masked_max_pool(xx, nbr[0], deg[0]) * w)

    jout = np.asarray(JN.masked_max_pool(jnp.asarray(x), nbr[0], deg[0]))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tn, td = TN.neighbor_table_from_scipy([m])
    xt = torch.from_numpy(x).requires_grad_()
    out = TN.masked_max_pool(xt, tn[0], td[0])
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL,
                               atol=TOL)
    assert not out.detach().numpy()[td[0].numpy() == 0].any()
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def origin(tmp_path_factory):
    """Two snapshots of a weighted graph on 60 named nodes (node u59
    isolated in both)."""
    base = tmp_path_factory.mktemp("adj")
    rng = np.random.default_rng(11)
    names = [f"u{i}" for i in range(60)]
    for t in range(2):
        src = rng.integers(0, 59, 150)
        dst = rng.integers(0, 59, 150)
        (base / f"2010-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"u{a}\tu{b}\t{rng.integers(1, 5)}\n"
                for a, b in zip(src, dst)))
    return base, names


@pytest.mark.parametrize("adj_backend, threshold, plans", [
    ("auto", 61, False), ("auto", 60, True), ("ell", 10 ** 6, True),
    ("segment", 0, False)])
@pytest.mark.parametrize("norm", [(True, True, True), (False, False, False),
                                  (False, False, True)],
                         ids=["gcn", "raw", "plus_eye"])
def test_date_adj_list_equals_jax(origin, adj_backend, threshold, plans,
                                  norm):
    """Each snapshot's graph and its product (and gradient) with the JAX
    window's, plans attached exactly where the JAX loader attaches its ELL
    plans; ``"auto"``'s threshold set on both loaders' class attribute."""
    base, names = origin
    normalize, row_norm, add_eye = norm
    kw = dict(normalize=normalize, row_norm=row_norm, add_eye=add_eye,
              adj_backend=adj_backend)
    tl, jl = TDataLoader(names, 2), JDataLoader(names, 2)
    tl.ELL_AUTO_NODES = jl.ELL_AUTO_NODES = threshold
    graphs = tl.get_date_adj_list(str(base), 0, 2, **kw)
    jwin = jl.get_date_adj_list(str(base), 0, 2, **kw)
    assert len(graphs) == 2
    assert (jwin.ell_fwd is not None) is plans
    assert all(g.backend == ("ell" if plans else "segment") for g in graphs)
    x, w = _x(12, 60), _x(13, 60)

    def jloss(xx):
        out = jax.vmap(lambda g: jspmm(g, xx))(jwin)
        return jnp.sum(jnp.tanh(out) * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    outs = torch.stack([TSP.spmm(g, xt) for g in graphs])
    (torch.tanh(outs) * torch.from_numpy(w)).sum().backward()
    for t, g in enumerate(graphs):
        jg = jax.tree.map(lambda a, t=t: a[t], JS.SparseGraph(
            rows=jwin.rows, cols=jwin.cols, vals=jwin.vals,
            n_rows=jwin.n_rows, n_cols=jwin.n_cols))
        np.testing.assert_allclose(TS.to_dense(g).numpy(),
                                   np.asarray(JS.to_dense(jg)), rtol=1e-7,
                                   atol=1e-7)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=TOL,
                               atol=TOL)


def test_unknown_adj_backend_raises(origin):
    base, names = origin
    with pytest.raises(ValueError, match="adj_backend"):
        TDataLoader(names, 2).get_date_adj_list(str(base), 0, 2,
                                                adj_backend="dense")
