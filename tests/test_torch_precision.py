# coding: utf-8
"""The config's ``matmul_precision`` in ``ctgcn_torch`` against
``ctgcn_tpu``: "bf16" (a bf16 dense bank or bf16 principal blocks, bf16
ELL gathers whose slot products are stored in bf16, and the prefix stored
in bf16 above the tail budget) and "high" (3xTF32 GEMMs on the card; on
the CPU both packages multiply in full f32).

The bf16 kernel wrappers run their plain version on these CPU tensors.
Tolerances, each with its reason:
  * bf16 bank and blocks slot products: rtol 1e-5 + 1e-5 * max|ref|: both
    multiply the same bf16-rounded operands exactly and sum in f32, in
    another order;
  * bf16 ELL products and their gradient: 1e-2 * max|ref| (+ rtol 1e-2):
    the port rounds each product sum to bf16 once, XLA may round each
    product to bf16 as well;
  * a CTGCN-C on bf16 delta-ELL plans: forward 1e-2, gradients 5e-2 of
    the largest value (as ``test_core_rnn_sum_bf16_storage``);
  * "high": forward 2e-5, gradients 5e-4 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from flax import serialization

from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.ops import bsr_spmm as B
from ctgcn_torch.ops import ell as TE
from ctgcn_torch.ops import pyramid as TP
from ctgcn_tpu.nn import core_models as JM
from ctgcn_tpu.ops import ell as JE
from ctgcn_tpu.ops import pyramid as JP
from tests.test_torch_backends import EMB, HID, K, N, T, WEIGHT, _window


def _build(backend, bf16=False, prec="highest"):
    """(port window, JAX window) on ``backend`` with a bf16 or f32 bank."""
    per_snap = _window()
    cap = max(m.nnz + N for mats in per_snap for m in mats)
    kw = {"dense": {"densify": True},
          "blocks": {"build_blocks": True}}.get(backend, {})
    tpyr = TP.stack_pyramids([
        TP.build_core_pyramid(m, N, K, dense_prec=prec,
                              dense_dtype=torch.bfloat16 if bf16 else None,
                              **kw) for m in per_snap])
    jpyr = JP.stack_pyramids([
        JP.build_core_pyramid(m, N, K, pad_to=cap, dense_prec=prec,
                              dense_dtype=jnp.bfloat16 if bf16 else None,
                              **kw) for m in per_snap])
    if backend == "ell":
        tpyr = TP.attach_ell_plans(tpyr, delta=True, bf16=bf16)
        jpyr = JP.attach_ell_plans(jpyr, delta=True, bf16=bf16)
    assert tpyr.backend == backend
    return tpyr, jpyr


def _assert_close_to_max(got, ref, tol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=tol * float(np.abs(ref).max()),
                               err_msg=err_msg)


@pytest.mark.parametrize("prec", ["bf16", "high"])
@pytest.mark.parametrize("backend", ["blocks", "dense"])
def test_bank_slot_products_equal_jax_contribs(backend, prec):
    """A bf16 bank (bf16 operands, f32 results), and "high" on an f32
    bank, against ``CoreDiffusion._contribs``."""
    tpyr, jpyr = _build(backend, bf16=prec == "bf16",
                        prec="high" if prec == "high" else "highest")
    want = torch.bfloat16 if prec == "bf16" else torch.float32
    banks = tpyr.blocks[0] if backend == "blocks" else (tpyr.dense,)
    assert all(b.dtype == want for b in banks)
    jlayer = JM.CoreDiffusion.init(jax.random.key(0), 12, 5)
    x = np.random.default_rng(1).standard_normal((N, 12)).astype(np.float32)
    contribs = jax.jit(lambda p: jlayer._contribs(jnp.asarray(x), p))
    for t in range(T):
        ref, _ = contribs(JP.pyramid_at(jpyr, t))
        got, _ = TM.slot_products(torch.from_numpy(x), TP.pyramid_at(tpyr, t))
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _powerlaw(rng, n=200, m=160):
    deg = np.minimum((rng.pareto(1.0, n) * 3).astype(int), n - 1)
    deg[rng.random(n) < 0.1] = 0
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()


@pytest.mark.parametrize("d", [17, 24])
def test_ell_spmm_bf16_value_and_grad_equal_jax(d):
    """``ell_spmm(..., bf16=True)``: bf16 products (d = 17 is padded to 24
    inside, a multiple of 8) and an f32 gradient through the transpose
    plan, against JAX's bf16 gathers and custom VJP."""
    rng = np.random.default_rng(4)
    m = _powerlaw(rng)
    fwd, tr = B.build_csr_plan(m), B.build_csr_plan(m.T)
    jf, jt = JE.build_ell_plans(m)
    x = rng.standard_normal((m.shape[1], d)).astype(np.float32)
    w = rng.standard_normal((m.shape[0], d)).astype(np.float32)

    def jloss(xx):
        return jnp.sum(JE.ell_spmm(jf, jt, xx, True) * w)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x))
    ref = np.asarray(JE.ell_spmm(jf, jt, jnp.asarray(x), True),
                     np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = TE.ell_spmm(fwd, tr, xt, bf16=True)
    assert out.dtype == torch.bfloat16 and out.shape == (m.shape[0], d)
    _assert_close_to_max(out.float().detach().numpy(), ref, 1e-2, 1e-2)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == torch.float32
    _assert_close_to_max(xt.grad.numpy(), np.asarray(jgrad), 1e-2, 1e-2)
    # the port itself: one rounding of an f32 sum of bf16 products
    def bf16(a):
        return torch.from_numpy(a).bfloat16().double().numpy()

    exact = sp.csr_matrix((bf16(m.data), m.indices, m.indptr),
                          shape=m.shape) @ bf16(x)
    np.testing.assert_allclose(out.float().detach().numpy(), exact,
                               rtol=2 ** -8, atol=1e-6)


def test_bf16_plain_rounds_inputs_then_sums_in_f32():
    """The bf16 kernels' plain version rounds x and the values to bf16,
    sums exactly representable products in f32 and rounds once."""
    m = sp.csr_matrix(np.array([[1.0 + 2 ** -10, 3.0], [0.0, 0.5]]))
    plan = B.build_csr_plan(m)
    x = torch.tensor([[1.0 + 2 ** -9] * 8, [2 ** -12] * 8])
    got = B.bsr_spmm_csr_plain_bf16(plan, x, torch.float32)
    # bf16(1 + 2^-10) = 1, bf16(1 + 2^-9) = 1 (ties to even), 2^-12 exact
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  [1.0 + 3 * 2 ** -12, 0.5 * 2 ** -12])
    assert B.bsr_spmm_csr_plain_bf16(plan, x).dtype == torch.bfloat16


@pytest.mark.parametrize("kernel", ["rowwalk", "blockpar"])
def test_bf16_wrappers_on_cpu(kernel):
    """On CPU tensors each bf16 wrapper runs the plain version, counts no
    launch and checks its input: bf16 x, d a multiple of 8, an out dtype
    of bf16 or f32; ``dispatch(..., bf16=True)`` picks it by the plan's
    longest row, as for f32."""
    wrapper = getattr(B, f"bsr_spmm_{kernel}_bf16")
    m = _powerlaw(np.random.default_rng(6))
    plan = B.build_csr_plan(m if kernel == "blockpar" else m.T)
    assert B.dispatch(plan, bf16=True) is (
        B.bsr_spmm_rowwalk_bf16 if plan.max_row_nnz <= B.ROWWALK_MAX_ROW
        else B.bsr_spmm_blockpar_bf16)
    x = torch.randn(plan.n_cols, 16).bfloat16()
    before = wrapper.launches
    for out_dtype in (torch.bfloat16, torch.float32):
        got = wrapper(plan, x, out_dtype)
        assert got.dtype == out_dtype
        torch.testing.assert_close(
            got, B.bsr_spmm_csr_plain_bf16(plan, x, out_dtype), rtol=0,
            atol=0)
    assert wrapper.launches == before
    for bad_x, out_dtype in ((x.float(), torch.bfloat16),
                             (x[:, :12].contiguous(), torch.bfloat16),
                             (x, torch.float16)):
        with pytest.raises(ValueError):
            wrapper(plan, bad_x, out_dtype)


def test_tf32_split_is_exact():
    """hi keeps TF32's 10 mantissa bits, hi + lo is the value exactly, and
    the three-GEMM product is within 2^-20 of the f32 product."""
    a = torch.randn(33, 40, generator=torch.Generator().manual_seed(0))
    b = torch.randn(40, 7, generator=torch.Generator().manual_seed(1))
    hi, lo = TM._tf32_split(a)
    assert not (hi.view(torch.int32) & 8191).any()
    assert torch.equal(hi + lo, a)
    assert float(lo.abs().max()) <= 2 ** -10 * float(a.abs().max())
    ref = a.double() @ b.double()
    err = (TM._mm_3xtf32(a, b).double() - ref).abs().max()
    assert float(err) <= 2 ** -20 * float(ref.abs().max())
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.fixture(scope="module")
def jax_model():
    return JM.CTGCN.init(jax.random.key(0), N, HID, EMB, trans_num=1,
                         diffusion_num=2, duration=T)


def _loss_and_grads(jmodel, jpyr):
    def loss(m):
        out = m(None, jpyr)
        return jnp.sum(jnp.tanh(out) * jnp.asarray(WEIGHT)), out

    (val, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jmodel)
    return float(val), np.asarray(out), params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(grads)))


def _port(jmodel, tpyr, **kw):
    tmodel = TM.CTGCN(N, HID, EMB, trans_num=1, diffusion_num=2, duration=T,
                      **kw)
    tmodel.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(jmodel))))
    out = tmodel(None, tpyr)
    loss = (torch.tanh(out) * torch.from_numpy(WEIGHT)).sum()
    loss.backward()
    return loss.item(), out.detach().numpy(), tmodel


@pytest.mark.parametrize("acc_bf16", [False, True],
                         ids=["acc_f32", "acc_bf16"])
def test_ctgcn_bf16_ell_equals_jax(jax_model, monkeypatch, acc_bf16):
    """CTGCN-C on bf16 delta-ELL plans, forward and every gradient; with
    ``acc_bf16`` both tail budgets are 0, so the prefix is stored in bf16
    before the core-axis RNN (the Enron configuration)."""
    tpyr, jpyr = _build("ell", bf16=True)
    assert tpyr.ell_bf16 and tpyr.ell_delta
    budget = 0 if acc_bf16 else TM.CORE_RNN_BUDGET
    monkeypatch.setenv("CTGCN_TPU_CORE_RNN_BUDGET", str(budget))
    jval, jout, ref_grads = _loss_and_grads(jax_model, jpyr)
    val, out, tmodel = _port(jax_model, tpyr, core_rnn_budget=budget)
    assert TM.acc_in_bf16(torch.bfloat16, K, N, HID, HID, False,
                          budget) == acc_bf16
    _assert_close_to_max(out, jout, 1e-2)
    np.testing.assert_allclose(val, jval, rtol=1e-2)
    for name, p in tmodel.named_parameters():
        _assert_close_to_max(p.grad.numpy(), ref_grads[name].numpy(), 5e-2,
                             err_msg=name)


@pytest.mark.parametrize("backend", ["blocks", "dense"])
def test_ctgcn_high_equals_jax(jax_model, backend):
    """``dense_prec: "high"``, forward and every gradient, against the
    JAX package's "high" (both full f32 on the CPU)."""
    tpyr, jpyr = _build(backend, prec="high")
    assert tpyr.dense_prec == "high"
    jval, jout, ref_grads = _loss_and_grads(jax_model, jpyr)
    val, out, tmodel = _port(jax_model, tpyr)
    np.testing.assert_allclose(out, jout, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(val, jval, rtol=2e-5)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=5e-4, atol=5e-4, err_msg=name)
