# coding: utf-8
"""CGCN-C, CGCN-S and CTGCN-S against ``ctgcn_tpu`` on the toy window of
``test_torch_ctgcn`` (N = 150, T = 3, K <= 3, hid 16, embed 8, one trans
layer for 'C' and three SELU layers for 'S', features of width 12 for the
S-variants and identity features for CGCN-C), on every core backend (the
JAX side runs its Pallas kernels in interpret mode on the BSR plans).

Parameters go across with ``params_from_numpy``; the U-neg loss takes the
JAX sampler's own draws, the reconstruction loss (U-own) the batch rows.
Also: ``reconstruction_loss`` alone, and the degree features, bit-equal to
the JAX loader's under the same ``RandomState``.
Tolerance: forward 2e-5; losses 1e-5 relative; gradients rtol / atol
5e-4 (1e-3 / 1e-4 on delta-encoded ELL slots, whose prefixes are summed
in another order than the full slots' products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ctgcn_torch import losses as TL
from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.ops import pyramid as TP
from ctgcn_tpu import losses as JL
from ctgcn_tpu.data.loader import DataLoader as JDataLoader
from ctgcn_tpu.nn import core_models as JM
from ctgcn_tpu.ops import pyramid as JP
from tests.test_torch_ctgcn import (EMB, HID, N, Q, S, T, _batch, _jax_draws,
                                    _walk_tables, _window)

FEAT = 12
BACKENDS = ["blocks", "dense", "ell_delta", "segment", "pallas"]
# method -> (JAX class, port class, model_type, trans_num, activation)
MODELS = {"CGCN-C": (JM.CGCN, TM.CGCN, "C", 1, "L"),
          "CGCN-S": (JM.CGCN, TM.CGCN, "S", 3, "N"),
          "CTGCN-S": (JM.CTGCN, TM.CTGCN, "S", 3, "N")}
CASES = [(m, loss) for m in MODELS
         for loss in (("uneg", "recon") if MODELS[m][2] == "S"
                      else ("uneg",))]
GRAD_TOL = {"ell_delta": (1e-3, 1e-4)}


@pytest.fixture(scope="module")
def windows():
    """(port window, JAX window) on each backend, and the S-variants'
    features."""
    per_snap = _window()
    K = max(len(m) for m in per_snap)
    cap = max(m.nnz + N for mats in per_snap for m in mats)
    out = {}
    for backend in BACKENDS:
        kw = {"dense": {"densify": True}, "blocks": {"build_blocks": True},
              "pallas": {"build_plans": True}}.get(backend, {})
        tpyr = TP.stack_pyramids([TP.build_core_pyramid(m, N, K, **kw)
                                  for m in per_snap])
        jpyr = JP.stack_pyramids([JP.build_core_pyramid(m, N, K, pad_to=cap,
                                                        **kw)
                                  for m in per_snap])
        if backend == "ell_delta":
            tpyr = TP.attach_ell_plans(tpyr, delta=True)
            jpyr = JP.attach_ell_plans(jpyr, delta=True)
        assert tpyr.backend == backend.split("_")[0]
        out[backend] = (tpyr, jpyr)
    xs = np.random.default_rng(5).standard_normal((T, N, FEAT)).astype(
        np.float32)
    return out, xs


def _init(method):
    jcls, tcls, model_type, trans_num, act = MODELS[method]
    in_dim = N if model_type == "C" else FEAT
    kw = dict(trans_num=trans_num, diffusion_num=2 if model_type == "C"
              else 1, model_type=model_type, trans_activate_type=act)
    if jcls is JM.CTGCN:
        kw["duration"] = T
    jmodel = jcls.init(jax.random.key(0), in_dim, HID, EMB, **kw)
    tmodel = tcls(in_dim, HID, EMB, **kw)
    state = params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(jmodel)))
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return jmodel, tmodel


@pytest.fixture(scope="module")
def walk():
    return _walk_tables()


def _jax_ref(method, loss, jpyr, xs, walk_j):
    """The JAX forward, loss and gradients (as a port state_dict), and the
    U-neg draws."""
    jmodel, _ = _init(method)
    b_idx, b_mask = _batch()
    key = jax.random.key(7)
    s_variant = MODELS[method][2] == "S"
    jxs = None if not s_variant else jnp.asarray(xs)

    def jloss(m):
        res = m(jxs, jpyr)
        if loss == "recon":
            val = JL.reconstruction_loss(res[0], res[1], jnp.asarray(b_idx),
                                         jnp.asarray(b_mask))
        else:
            val = JL.negative_sampling_loss(
                res[0] if s_variant else res, jnp.asarray(b_idx),
                jnp.asarray(b_mask), walk_j, key, neg_num=S, Q=Q)
        return val, res

    (val, res), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jmodel)
    draws = _jax_draws(key, walk_j, b_idx) if loss == "uneg" else None
    return (float(val), jax.tree.map(np.asarray, res), params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(grads))),
        draws)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method, loss", CASES)
def test_forward_loss_and_grads_equal_jax(windows, walk, method, loss,
                                          backend):
    pyrs, xs = windows
    tpyr, jpyr = pyrs[backend]
    walk_j, walk_t = walk
    jval, jres, ref_grads, draws = _jax_ref(method, loss, jpyr, xs, walk_j)
    _, tmodel = _init(method)
    s_variant = MODELS[method][2] == "S"
    res = tmodel(torch.from_numpy(xs) if s_variant else None, tpyr)
    b_idx, b_mask = (torch.from_numpy(a) for a in _batch())
    if loss == "recon":
        val = TL.reconstruction_loss(res[0], res[1], b_idx.long(), b_mask)
    else:
        val = TL.uneg_loss(res[0] if s_variant else res, b_idx.long(),
                           b_mask, walk_t, *draws, Q=Q)
    val.backward()
    outs = (res if s_variant else (res,))
    refs = (jres if s_variant else (jres,))
    assert outs[0].shape == (T, N, EMB)
    for got, ref in zip(outs, refs, strict=True):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(val.item(), jval, rtol=1e-5)
    rtol, atol = GRAD_TOL.get(backend, (5e-4, 5e-4))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["batch", "masked"])
def test_reconstruction_loss_equals_jax(masked):
    """The MSE summed over timestamps: over all rows, over batch rows, and
    over the masked-in batch rows (padding rows hold arbitrary ids)."""
    rng = np.random.default_rng(8)
    embs = rng.standard_normal((T, 30, 6)).astype(np.float32)
    trans = rng.standard_normal((T, 30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, 11).astype(np.int32)
    mask = rng.random(11) < 0.7 if masked else None
    te, tt = torch.from_numpy(embs), torch.from_numpy(trans)
    np.testing.assert_allclose(
        TL.reconstruction_loss(te, tt).item(),
        float(JL.reconstruction_loss(jnp.asarray(embs), jnp.asarray(trans))),
        rtol=1e-6)
    got = TL.reconstruction_loss(
        te, tt, torch.from_numpy(idx).long(),
        None if mask is None else torch.from_numpy(mask))
    ref = JL.reconstruction_loss(
        jnp.asarray(embs), jnp.asarray(trans), jnp.asarray(idx),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.fixture(scope="module")
def origin_tree(tmp_path_factory):
    """Three weighted snapshots of 40 named nodes."""
    base = tmp_path_factory.mktemp("feat")
    rng = np.random.default_rng(9)
    names = [f"v{i}" for i in range(40)]
    (base / "1.format").mkdir()
    for t in range(3):
        src = rng.integers(0, 40, 120)
        dst = rng.integers(0, 40 // (t + 1) + 3, 120) % 40
        w = rng.integers(1, 4, 120)
        (base / "1.format" / f"2000-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n"
            + "".join(f"v{a}\tv{b}\t{c}\n" for a, b, c in zip(src, dst, w)))
    return base / "1.format", names


@pytest.mark.parametrize("init_type", ["gaussian", "one-hot", "adj",
                                       "combine"])
def test_degree_features_equal_jax(origin_tree, init_type):
    """Every ``init_type``, bit-equal to the JAX loader's, each side
    drawing from its own ``RandomState`` with the same seed."""
    origin, names = origin_tree
    got, got_dim = TDataLoader(names, 3).get_degree_feature_list(
        str(origin), 0, 3, init_type=init_type, std=1e-4,
        rng=np.random.RandomState(3))
    ref, ref_dim = JDataLoader(names, 3).get_degree_feature_list(
        str(origin), 0, 3, init_type=init_type, std=1e-4,
        rng=np.random.RandomState(3))
    assert got_dim == ref_dim and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_file_features_equal_jax(origin_tree, tmp_path):
    """File features: zero-padded to the widest file, read without
    pandas; no folder means identity features (None, N)."""
    origin, names = origin_tree
    rng = np.random.default_rng(10)
    for t, width in enumerate((3, 5, 4)):
        vals = rng.standard_normal((40, width))
        (tmp_path / f"2000-0{t + 1}.csv").write_text(
            "\t".join(f"f{j}" for j in range(width)) + "\n"
            + "".join("\t".join(repr(float(v)) for v in row) + "\n"
                      for row in vals))
    got, got_dim = TDataLoader(names, 3).get_feature_list(str(tmp_path), 0, 3)
    ref, ref_dim = JDataLoader(names, 3).get_feature_list(str(tmp_path), 0, 3)
    assert got_dim == ref_dim == 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert TDataLoader(names, 3).get_feature_list(None, 0, 3) == (None, 40)
