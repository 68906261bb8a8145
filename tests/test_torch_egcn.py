# coding: utf-8
"""The zoo's EvolveGCN (``ctgcn_torch/nn/egcn.py``) against ``ctgcn_tpu``
on the CPU, class by class, with inputs from numpy seeds and the JAX
parameters carried over by ``params_from_numpy``; the graphs are the zoo's
generated dataset's (``tests/test_torch_zoo.py``: N = 120, two weighted
snapshots) under EvolveGCN's D^-1/2 (A + I) D^-1/2.

  * ``_rrelu``: without a generator (a key) equal to the JAX function,
    values and gradient (1 at x = 0); with one, each element's slope in
    [1/8, 1/3) with a mean within 0.229 +- 0.005 over 10^5 entries, in
    both packages.
  * ``MatGRUGate``, ``TopK`` (with two equal rows tied in the top k),
    ``MatGRUCell`` (EGCNH and EGCNO), ``GRCU`` and ``EvolveGCN`` (segment
    and plans, EGCNH and EGCNO): forward within 1e-5 (rtol and atol) and
    parameter gradients within 1e-4 of the value plus 1e-4 of the largest
    gradient (the zoo's tolerances).  Tied scores may be taken in another
    order, so no test compares the selected indices.
  * ``TopK`` with fewer nodes than k raises in both packages.
  * The driver: EvolveGCN's degree features bit-equal for one seed (the
    JAX driver draws from the global ``np.random``), its symmetric window,
    its model from ``hid_dim``, ``embed_dim`` and ``model_type`` only (no
    bias and no dropout though the config gives them), the U-neg loss
    against the JAX driver's with no key, and the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.nn import egcn as TE
from ctgcn_torch.training import driver as TD
from ctgcn_tpu.data.loader import DataLoader as JDataLoader
from ctgcn_tpu.nn import egcn as JE
from ctgcn_tpu.training import driver as JD
from tests.test_torch_zoo import (EMB, FWD_TOL, HID, N, T, _check_grads,
                                  _cli_run, _driver_window_and_loss, _load,
                                  dataset)  # noqa: F401

FEAT = 9
RRELU_MEAN = (1.0 / 8.0 + 1.0 / 3.0) / 2.0


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sym_windows(dataset, adj_backend):
    """(port graphs, JAX window) of both snapshots under D^-1/2 (A + I)
    D^-1/2, as the drivers give EvolveGCN."""
    base, names, _ = dataset
    kw = dict(normalize=True, row_norm=False, add_eye=True,
              adj_backend=adj_backend)
    origin = str(base / "1.format")
    return (TDataLoader(names, T).get_date_adj_list(origin, 0, T, **kw),
            JDataLoader(names, T).get_date_adj_list(origin, 0, T, **kw))


def _check(jmodule, tmodule, jcall, tcall, w_seed=4):
    """Forward and the parameters' gradients of sum(tanh(out) * w), w
    normal of the output's shape, in both packages."""
    jout0 = np.asarray(jcall(jmodule))
    w = _np(w_seed, *jout0.shape)

    def jloss(m):
        out = jcall(m)
        return jnp.sum(jnp.tanh(out) * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jmodule)
    out = tcall(tmodule)
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(tmodule, jgrads)
    return out


def test_rrelu_eval_equals_jax_with_unit_gradient_at_zero():
    x = _np(0, 64, 5)
    x[0, :3] = 0.0
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x).requires_grad_()
    out = TE._rrelu(tx)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(JE._rrelu(jx)))
    out.sum().backward()
    jgrad = np.asarray(jax.grad(lambda v: JE._rrelu(v).sum())(jx))
    np.testing.assert_array_equal(tx.grad.numpy(), jgrad)
    assert (tx.grad.numpy()[0, :3] == 1.0).all()
    assert np.isclose(jgrad[x < 0], RRELU_MEAN).all()


def test_rrelu_train_slopes_are_uniform():
    """x = -1 everywhere: -out is each entry's slope."""
    x = -torch.ones(100_000)
    slopes = -TE._rrelu(x, torch.Generator().manual_seed(0))
    jslopes = -np.asarray(JE._rrelu(-jnp.ones(100_000), jax.random.key(0)))
    for s in (slopes.numpy(), jslopes):
        assert s.min() >= 1.0 / 8.0 and s.max() < 1.0 / 3.0
        assert abs(float(s.mean()) - 0.229) < 0.005
    assert not torch.equal(
        slopes, -TE._rrelu(x, torch.Generator().manual_seed(1)))
    # positive entries pass through, whatever is drawn
    assert torch.equal(TE._rrelu(-x, torch.Generator().manual_seed(0)), -x)


def test_mat_gru_gate_equals_jax():
    rows, cols = 7, 4
    jgate = JE.MatGRUGate.init(jax.random.key(1), rows, cols)
    tgate = _load(TE.MatGRUGate(rows, cols), jgate)
    assert tuple(tgate.bias.shape) == (rows, cols)
    x, h = _np(1, rows, cols), _np(2, rows, cols)
    _check(jgate, tgate,
           lambda g: g(jnp.asarray(x), jnp.asarray(h), jax.nn.sigmoid),
           lambda g: g(torch.from_numpy(x), torch.from_numpy(h),
                       torch.sigmoid))


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tie"])
def test_topk_equals_jax(tie):
    """[feats, k] of the top k rows scaled by tanh(score); with ``tie``
    rows 3 and 30 are equal and both in the top k, so their order may
    differ between the packages and the output may not."""
    feats, k, n = 6, 5, 40
    jtopk = JE.TopK.init(jax.random.key(2), feats, k)
    ttopk = _load(TE.TopK(feats, k), jtopk)
    x = _np(3, n, feats)
    scorer = np.asarray(jtopk.scorer)[:, 0]
    if tie:
        best = x[np.argmax(x @ scorer)]
        x[3] = x[30] = best + 0.5 * scorer / np.linalg.norm(scorer)
        scores = x @ scorer
        assert scores[3] == scores[30]
        assert {3, 30} <= set(np.argsort(-scores)[:k].tolist())
    out = _check(jtopk, ttopk, lambda m: m(jnp.asarray(x)),
                 lambda m: m(torch.from_numpy(x)))
    assert tuple(out.shape) == (feats, k)


def test_topk_needs_k_nodes():
    """No mask and no padding: fewer nodes than k raises in both."""
    x = _np(4, 3, 6)
    with pytest.raises(ValueError, match="k"):
        TE.TopK(6, 5)(torch.from_numpy(x))
    with pytest.raises(ValueError, match="k"):
        JE.TopK.init(jax.random.key(0), 6, 5)(jnp.asarray(x))


@pytest.mark.parametrize("egcn_type", ["EGCNH", "EGCNO"])
def test_mat_gru_cell_equals_jax(egcn_type):
    """The weight [in, out] evolved once: EGCNH from the TopK summary of
    node features, EGCNO from the weight itself."""
    d_in, d_out, n = 6, 4, 30
    jcell = JE.MatGRUCell.init(jax.random.key(3), d_in, d_out, egcn_type)
    tcell = _load(TE.MatGRUCell(d_in, d_out, egcn_type), jcell)
    q, z = _np(5, d_in, d_out), _np(6, n, d_in)
    if egcn_type == "EGCNO":
        _check(jcell, tcell, lambda c: c(jnp.asarray(q)),
               lambda c: c(torch.from_numpy(q)))
    else:
        _check(jcell, tcell, lambda c: c(jnp.asarray(q), jnp.asarray(z)),
               lambda c: c(torch.from_numpy(q), torch.from_numpy(z)))


@pytest.mark.parametrize("egcn_type, adj_backend", [
    ("EGCNH", "segment"), ("EGCNH", "ell"), ("EGCNO", "segment")])
def test_grcu_equals_jax(dataset, egcn_type, adj_backend):
    tgraphs, jwin = _sym_windows(dataset, adj_backend)
    jgrcu = JE.GRCU.init(jax.random.key(4), FEAT, HID, egcn_type)
    tgrcu = _load(TE.GRCU(FEAT, HID, egcn_type), jgrcu)
    xs = _np(7, T, N, FEAT)
    _check(jgrcu, tgrcu, lambda m: m(jwin, jnp.asarray(xs)),
           lambda m: m(tgraphs, torch.from_numpy(xs)))


@pytest.mark.parametrize("egcn_type, adj_backend", [
    ("EGCNH", "segment"), ("EGCNH", "ell"), ("EGCNO", "ell")])
def test_evolvegcn_equals_jax(dataset, egcn_type, adj_backend):
    """Both layers, no key (rrelu at its mean slope), on graphs with the
    kernels' plans (``EvPlan`` pairs) or without."""
    tgraphs, jwin = _sym_windows(dataset, adj_backend)
    assert all(g.backend == ("ell" if adj_backend == "ell" else "segment")
               for g in tgraphs)
    jmodel = JE.EvolveGCN.init(jax.random.key(5), FEAT, HID, EMB, egcn_type)
    tmodel = _load(TE.EvolveGCN(FEAT, HID, EMB, egcn_type), jmodel)
    xs = _np(8, T, N, FEAT)
    out = _check(jmodel, tmodel, lambda m: m(jnp.asarray(xs), jwin),
                 lambda m: m(torch.from_numpy(xs), tgraphs))
    assert tuple(out.shape) == (T, N, EMB)


def test_degree_features_equal_jax(dataset):
    """EvolveGCN's features when the config names no feature files:
    N(weighted degree, std) of width max_degree + 1 over the window, the
    port's ``rng`` and the JAX driver's global ``np.random`` seeded
    alike."""
    _, _, emb = dataset
    jargs, targs = dict(emb["EvolveGCN"]), dict(emb["EvolveGCN"])
    assert jargs["init_type"] == "gaussian" and jargs["std"] == 1e-4
    jl, tl = JD.get_data_loader(jargs), TD.get_data_loader(targs)
    np.random.seed(21)
    in_j, _, jxs, _ = JD.get_input_data("EvolveGCN", 0, T, jl, jargs)
    in_t, data = TD.get_input_data("EvolveGCN", 0, T, tl, targs,
                                   rng=np.random.RandomState(21))
    xs = data["xs"].numpy()
    np.testing.assert_array_equal(xs, np.asarray(jxs))
    raw = tl.get_scipy_adj_list(targs["origin_base_path"], 0, T)
    degrees = np.stack([np.asarray(m.sum(1)).ravel() for m in raw])
    assert in_t == in_j == int(degrees.max()) + 1 == xs.shape[-1]
    assert np.abs(xs - degrees[..., None]).max() < 1e-4 * 6


def test_driver_ignores_dropout_and_bias():
    """configs/uci.json's EvolveGCN entry gives ``dropout`` and ``bias``;
    the JAX factory passes neither: no bias parameter, nothing dropped,
    the same tree in both packages."""
    args = {"input_dim": FEAT, "hid_dim": HID, "embed_dim": EMB,
            "dropout": 0.5, "bias": True}
    jmodel = JD.get_gnn_model("EvolveGCN", T, dict(args), jax.random.key(0))
    tmodel = TD.get_gnn_model("EvolveGCN", T, dict(args),
                              torch.Generator().manual_seed(0))
    assert tmodel.grcu1.egcn_type == jmodel.grcu1.egcn_type == "EGCNH"
    names = set(tmodel.state_dict())
    assert {n for n in names if n.endswith("bias")} == {
        f"grcu{l}.evolve_weights.{g}.bias" for l in (1, 2)
        for g in ("update", "reset", "htilda")}
    _load(tmodel, jmodel)


@pytest.mark.parametrize("change", [
    {}, {"adj_backend": "ell"}, {"model_type": "EGCNO"}],
    ids=["segment", "ell", "EGCNO"])
def test_driver_window_and_loss_equal_jax(dataset, change):
    """Both drivers' window (D^-1/2 (A + I) D^-1/2, degree features),
    models and U-neg loss, the forward given no key."""
    _driver_window_and_loss(dataset, "EvolveGCN", change)


def test_cli_runs_evolvegcn(dataset, tmp_path):
    """configs/uci.json's EvolveGCN entry at test width (gaussian degree
    features, duration 7, so one window of both snapshots), one epoch on
    the CPU: finite losses, one CSV per snapshot, the model file."""
    _cli_run(dataset, tmp_path, "EvolveGCN")
