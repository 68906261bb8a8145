# coding: utf-8
"""The core backends of ``ctgcn_torch`` (principal blocks, dense bank,
ELL/CSR plans full-slot and delta-encoded, padded COO, BSR plans) against
``ctgcn_tpu`` on a toy weighted window (N = 64, T = 2, K = 4 slots of which
the last is invalid in every snapshot, hid 8, embed 6, two CoreDiffusion
layers; the JAX side runs its Pallas kernels in interpret mode).

The port's kernel wrappers run their plain versions on these CPU tensors.
Tolerances: slot products rtol 1e-5 + 1e-5 * max|ref| (f32 sums in another
order); the CTGCN-C forward 2e-5; gradients 5e-4, and 1e-3 / 1e-4
(rtol / atol) for delta-encoded slots, whose prefixes are summed in
another order than the full slots' products.

On every backend, the port's CTGCN-C stepping only each snapshot's kept
slots (the pyramid's ``kept``) against the masked run over all K
(``kept=None``): the forward bit-equal; the gradients bit-equal in the
lean mode of ``core_rnn_sum`` on full slots, else within rtol 1e-6 (sums
over the slot axis in another order: the K-batched mode's, the delta
prefix's "+ x").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from flax import serialization

from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.ops import pyramid as TP
from ctgcn_tpu.nn import core_models as JM
from ctgcn_tpu.ops import pyramid as JP

N, T, K, HID, EMB = 64, 2, 4, 8, 6
BACKENDS = ["dense", "blocks", "ell_full", "ell_delta", "segment", "pallas"]


def _window(seed=0):
    """T snapshots of nested weighted k-core matrices, max core first,
    three cores each (so slot 3 of K = 4 is invalid)."""
    rng = np.random.default_rng(seed)
    per_snap = []
    for _ in range(T):
        dense = (rng.random((N, N)) < 0.12) * rng.integers(1, 5, (N, N))
        a = np.triu(dense, 1)
        a = (a + a.T).astype(np.float64)
        deg = (a != 0).sum(1)
        per_snap.append([sp.csr_matrix(a * np.outer(deg >= k, deg >= k))
                         for k in (9, 7, 1)])
    return per_snap


def _build(backend, per_snap):
    """(port window, JAX window) on ``backend``, both stacked over T."""
    cap = max(m.nnz + N for mats in per_snap for m in mats)
    kw = {"dense": {"densify": True}, "blocks": {"build_blocks": True},
          "pallas": {"build_plans": True}}.get(backend, {})
    tpyr = TP.stack_pyramids([TP.build_core_pyramid(m, N, K, **kw)
                              for m in per_snap])
    jpyr = JP.stack_pyramids([JP.build_core_pyramid(m, N, K, pad_to=cap,
                                                    **kw)
                              for m in per_snap])
    if backend.startswith("ell"):
        delta = backend == "ell_delta"
        tpyr = TP.attach_ell_plans(tpyr, delta=delta)
        jpyr = JP.attach_ell_plans(jpyr, delta=delta)
    return tpyr, jpyr


@pytest.fixture(scope="module")
def window():
    per_snap = _window()
    pyrs = {b: _build(b, per_snap) for b in BACKENDS}
    valid = pyrs["segment"][0].valid.numpy()
    assert valid[:, :3].all() and not valid[:, 3].any()
    return pyrs


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_products_equal_jax_contribs(window, backend):
    tpyr, jpyr = window[backend]
    assert tpyr.backend == backend.split("_")[0]
    jlayer = JM.CoreDiffusion.init(jax.random.key(0), 12, 5)
    x = np.random.default_rng(1).standard_normal((N, 12)).astype(np.float32)
    contribs = jax.jit(lambda p: jlayer._contribs(jnp.asarray(x), p))
    for t in range(T):
        ref, ref_xp = contribs(JP.pyramid_at(jpyr, t))
        got, got_xp = TM.slot_products(torch.from_numpy(x),
                                       TP.pyramid_at(tpyr, t))
        ref = np.asarray(ref)
        assert got.shape == (K, N, 12)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
        np.testing.assert_array_equal(got_xp.numpy(), np.asarray(ref_xp))


def test_perm_equals_jax(window):
    tpyr, jpyr = window["blocks"]
    for t in range(T):
        np.testing.assert_array_equal(tpyr.perm[t].numpy(),
                                      np.asarray(jpyr.perm[t]))
        np.testing.assert_array_equal(tpyr.inv_perm[t].numpy(),
                                      np.asarray(jpyr.inv_perm[t]))
        assert len(tpyr.blocks[t]) == 3
        for mine, theirs in zip(tpyr.blocks[t], jpyr.blocks[t], strict=True):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_blocks_need_nested_supports():
    """Supports that do not nest leave the blocks out (the loader then
    takes the dense bank), as in the JAX package."""
    a = sp.csr_matrix(np.triu(np.ones((6, 6)), 1) + np.triu(np.ones((6, 6)),
                                                            1).T)
    b = sp.csr_matrix(a.multiply(np.outer(np.arange(6) < 3,
                                          np.arange(6) < 3)))
    c = sp.csr_matrix(a.multiply(np.outer(np.arange(6) >= 3,
                                          np.arange(6) >= 3)))
    pyr = TP.build_core_pyramid([b, c], 6, 2, build_blocks=True)
    assert pyr.blocks is None and pyr.backend == "segment"
    assert JP.build_core_pyramid([b, c], 6, 2, build_blocks=True).blocks \
        is None


WEIGHT = np.random.default_rng(2).standard_normal((T, N, EMB)).astype(
    np.float32)


@jax.jit
def _jax_loss_and_grads(model, pyramids):
    def loss(m):
        out = m(None, pyramids)
        return jnp.sum(jnp.tanh(out) * jnp.asarray(WEIGHT)), out

    return jax.value_and_grad(loss, has_aux=True)(model)


@pytest.fixture(scope="module")
def jax_ref(window):
    """The JAX model's parameters, and per backend (computed once) its
    loss, forward and gradients as a port state_dict."""
    model = JM.CTGCN.init(jax.random.key(0), N, HID, EMB, trans_num=1,
                          diffusion_num=2, duration=T)
    cache = {}

    def ref(backend):
        if backend not in cache:
            (val, out), grads = _jax_loss_and_grads(model,
                                                    window[backend][1])
            cache[backend] = (float(val), np.asarray(out), params_from_numpy(
                jax.tree.map(np.asarray, serialization.to_state_dict(grads))))
        return cache[backend]

    return params_from_numpy(jax.tree.map(
        np.asarray, serialization.to_state_dict(model))), ref

# forward tolerance, then (rtol, atol) of the gradients
TOL = {"blocks": (2e-5, 5e-4, 5e-4), "dense": (2e-5, 5e-4, 5e-4),
       "segment": (2e-5, 5e-4, 5e-4), "ell_full": (2e-5, 5e-4, 5e-4),
       "ell_delta": (2e-5, 1e-3, 1e-4)}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("backend", sorted(TOL))
def test_ctgcn_forward_and_grads_equal_jax(window, jax_ref, backend, remat):
    """CTGCN-C forward and every parameter gradient, the JAX model's
    parameters mapped with ``params_from_numpy``; ``remat`` recomputes
    each timestep in the backward (``torch.utils.checkpoint``)."""
    state, ref = jax_ref
    jval, jout, ref_grads = ref(backend)
    fwd_tol, g_rtol, g_atol = TOL[backend]
    tmodel = TM.CTGCN(N, HID, EMB, trans_num=1, diffusion_num=2, duration=T,
                      act_budget=0 if remat else TM.ACT_BUDGET)
    tmodel.load_state_dict(state)
    out = tmodel(None, window[backend][0])
    loss = (torch.tanh(out) * torch.from_numpy(WEIGHT)).sum()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=fwd_tol,
                               atol=fwd_tol)
    np.testing.assert_allclose(loss.item(), jval, rtol=fwd_tol)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=g_rtol, atol=g_atol, err_msg=name)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("cvjp", ["lean", "K-batched"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_ctgcn_trimmed_equals_masked(window, backend, cvjp, remat):
    """CTGCN-C over the kept slots (3 of K = 4 in each snapshot) against
    the same model over all K slots masked, forward and every parameter's
    gradient; ``remat`` recomputes each timestep in the backward."""
    tpyr = window[backend][0]
    assert tpyr.kept == (3,) * T
    model = TM.CTGCN(N, HID, EMB, trans_num=1, diffusion_num=2, duration=T,
                     generator=torch.Generator().manual_seed(3),
                     act_budget=0 if remat else TM.ACT_BUDGET,
                     cvjp_batch_budget=0 if cvjp == "lean"
                     else TM.CVJP_BATCH_BUDGET)

    def run(pyramids):
        model.zero_grad(set_to_none=True)
        out = model(None, pyramids)
        (torch.tanh(out) * torch.from_numpy(WEIGHT)).sum().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}

    out0, g0 = run(dataclasses.replace(tpyr, kept=None))
    out1, g1 = run(tpyr)
    assert torch.equal(out1, out0)
    exact = cvjp == "lean" and backend != "ell_delta"
    for name, g in g0.items():
        if exact:
            assert torch.equal(g1[name], g), name
        else:
            torch.testing.assert_close(g1[name], g, rtol=1e-6,
                                       atol=1e-6 * float(g.abs().max()),
                                       msg=name)
