# coding: utf-8
"""GRU/LSTM cells, ``rnn_scan`` and ``core_rnn_sum`` of the port against
``ctgcn_tpu.ops.rnn`` -- the cases of ``tests/unit/test_core_vjp.py``:
GRU and LSTM, three validity masks, the K-batched and the lean backward.
Inputs come from numpy; parameters are the JAX cell's, copied.
Tolerance: f32 values 1e-5, gradients 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from ctgcn_torch.ops import rnn as T
from ctgcn_tpu.ops import rnn as J

MASKS = [
    np.array([1, 1, 1, 1, 1, 1], np.float32),
    np.array([1, 1, 0, 1, 0, 1], np.float32),
    np.array([0, 1, 1, 0, 0, 0], np.float32),
]


def _cells(rnn_type, d, H, seed):
    jcell = (J.GRUCell if rnn_type == "GRU" else J.LSTMCell).init(
        jax.random.key(seed), d, H)
    tcell = (T.GRUCell if rnn_type == "GRU" else T.LSTMCell)(d, H)
    tcell.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in jcell._asdict().items()})
    return jcell, tcell


def _close(got, ref, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_cell_step_matches(rnn_type):
    rng = np.random.default_rng(0)
    jcell, tcell = _cells(rnn_type, 9, 6, 1)
    x = rng.standard_normal((11, 9)).astype(np.float32)
    h = rng.standard_normal((11, 6)).astype(np.float32)
    if rnn_type == "GRU":
        ref = jcell(jnp.asarray(h), jnp.asarray(x))
        got = tcell(torch.from_numpy(h), torch.from_numpy(x))
        _close(got, ref, 1e-5)
    else:
        c = rng.standard_normal((11, 6)).astype(np.float32)
        ref = jcell((jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x))
        got = tcell((torch.from_numpy(h), torch.from_numpy(c)),
                    torch.from_numpy(x))
        for a, b in zip(got, ref):
            _close(a, b, 1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_rnn_scan_matches(rnn_type, masked):
    rng = np.random.default_rng(1)
    jcell, tcell = _cells(rnn_type, 5, 7, 2)
    xs = rng.standard_normal((6, 13, 5)).astype(np.float32)
    mask = MASKS[1].astype(bool) if masked else None
    jouts, jcarry = J.rnn_scan(jcell, jnp.asarray(xs),
                               mask=None if mask is None
                               else jnp.asarray(mask))
    touts, tcarry = T.rnn_scan(tcell, torch.from_numpy(xs),
                               mask=None if mask is None
                               else torch.from_numpy(mask))
    _close(touts, jouts, 1e-5)
    for a, b in zip(jax.tree.leaves(tcarry), jax.tree.leaves(jcarry)):
        _close(a, b, 1e-5)


def _jax_loss(cell, acc, valid):
    return jnp.sum(jnp.tanh(J.core_rnn_sum(cell, acc, valid)) ** 2)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("mask_i", range(len(MASKS)))
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_core_rnn_sum_matches(rnn_type, mask_i, batched, monkeypatch):
    """Values, and gradients w.r.t. acc and every cell parameter through a
    nonlinear head, in both backward modes on both sides (the JAX side's
    byte gate is its environment variable; the port's is an argument)."""
    budget = T.CVJP_BATCH_BUDGET if batched else 0
    monkeypatch.setenv("CTGCN_TPU_CVJP_BATCH_BUDGET", str(budget))
    K, n, d, H = 6, 23, 10, 7
    rng = np.random.default_rng(mask_i)
    jcell, tcell = _cells(rnn_type, d, H, 5)
    acc = rng.standard_normal((K, n, d)).astype(np.float32)
    valid = MASKS[mask_i]
    assert T._batched(rnn_type == "LSTM", torch.from_numpy(acc), H,
                      budget) == batched

    ref = jax.jit(J.core_rnn_sum)(jcell, jnp.asarray(acc), jnp.asarray(valid))
    jval, (jg_cell, jg_acc) = jax.jit(
        jax.value_and_grad(_jax_loss, argnums=(0, 1)))(
            jcell, jnp.asarray(acc), jnp.asarray(valid))

    acc_t = torch.from_numpy(acc).requires_grad_()
    got = T.core_rnn_sum(tcell, acc_t, torch.from_numpy(valid),
                         batch_budget=budget)
    _close(got, ref, 1e-5)
    loss = torch.tanh(got).square().sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    _close(acc_t.grad, jg_acc, 1e-4)
    for name, g in jg_cell._asdict().items():
        _close(getattr(tcell, name).grad, g, 1e-4)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_core_rnn_sum_matches_autograd_of_plain_loop(rnn_type, batched):
    """The hand-written backward against torch autograd through
    ``rnn_scan`` of relu(acc) * valid, summed over the core axis."""
    K, n, d, H = 5, 17, 8, 6
    rng = np.random.default_rng(11)
    _, tcell = _cells(rnn_type, d, H, 3)
    acc = torch.from_numpy(rng.standard_normal((K, n, d)).astype(np.float32))
    valid = torch.tensor([1, 0, 1, 1, 0], dtype=torch.float32)
    budget = T.CVJP_BATCH_BUDGET if batched else 0

    a1 = acc.clone().requires_grad_()
    torch.tanh(T.core_rnn_sum(tcell, a1, valid, budget)).sum().backward()
    g1 = {k: p.grad.clone() for k, p in tcell.named_parameters()}
    tcell.zero_grad(set_to_none=True)
    a2 = acc.clone().requires_grad_()
    hx = torch.relu(a2) * valid[:, None, None]
    outs, _ = T.rnn_scan(tcell, hx, mask=valid.bool())
    torch.tanh(outs.sum(0)).sum().backward()
    torch.testing.assert_close(a1.grad, a2.grad, rtol=1e-4, atol=1e-5)
    for k, p in tcell.named_parameters():
        torch.testing.assert_close(g1[k], p.grad, rtol=1e-4, atol=1e-5)


def test_core_rnn_sum_under_checkpoint():
    """torch.utils.checkpoint around core_rnn_sum (the per-timestep remat
    of the window forward) gives the same gradients."""
    K, n, d, H = 5, 13, 6, 4
    rng = np.random.default_rng(9)
    _, tcell = _cells("GRU", d, H, 9)
    acc = torch.from_numpy(rng.standard_normal((K, n, d)).astype(np.float32))
    valid = torch.ones(K)

    def f(a):
        return T.core_rnn_sum(tcell, a, valid).square().sum()

    grads = []
    for remat in (False, True):
        a = acc.clone().requires_grad_()
        tcell.zero_grad(set_to_none=True)
        (checkpoint(f, a, use_reentrant=False) if remat else f(a)).backward()
        grads.append([a.grad] + [p.grad for p in tcell.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_core_rnn_sum_bf16_storage():
    """A bf16 ``acc`` stores bf16 carries (the JAX package's large-graph
    configuration): the output stays f32 and tracks the JAX bf16 path
    within bf16 rounding (values 1e-2, gradients 5e-2)."""
    K, n, d, H = 6, 19, 8, 5
    rng = np.random.default_rng(2)
    jcell, tcell = _cells("GRU", d, H, 2)
    acc = rng.standard_normal((K, n, d)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    ref = jax.jit(J.core_rnn_sum)(jcell, jnp.asarray(acc, jnp.bfloat16),
                                  jnp.asarray(valid))
    jg = jax.jit(jax.grad(lambda a: jnp.sum(J.core_rnn_sum(
        jcell, a.astype(jnp.bfloat16), jnp.asarray(valid)) ** 2)))(
            jnp.asarray(acc))
    a = torch.from_numpy(acc).requires_grad_()
    got = T.core_rnn_sum(tcell, a.bfloat16(), torch.from_numpy(valid))
    assert got.dtype == torch.float32
    _close(got, ref, 1e-2)
    got.square().sum().backward()
    _close(a.grad, jg, 5e-2)
