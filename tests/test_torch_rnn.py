# coding: utf-8
"""GRU/LSTM cells, ``rnn_scan`` and ``core_rnn_sum`` of the port against
``ctgcn_tpu.ops.rnn`` -- the cases of ``tests/unit/test_core_vjp.py``:
GRU and LSTM, three validity masks, the K-batched and the lean backward.
Inputs come from numpy; parameters are the JAX cell's, copied.
Tolerance: f32 values 1e-5, gradients 1e-4.

The valid prefix alone (the host's ``kept`` of K slots, the empty ones a
suffix) against the masked run over all K slots (``kept=None``), through
``core_rnn_sum`` and ``CoreDiffusion.tail`` per snapshot and T-batched:
bit-equal, but for the sums over the slot axis that run shorter (the
K-batched weight and bias gradients, the delta prefix's ``x`` gradient)
and the K-batched backward's batched GEMMs: rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.ops import rnn as T
from ctgcn_torch.training import profiling
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


def _near(got, want):
    """Equal to round-off of a sum over the slot axis in another order."""
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _spy_modes(monkeypatch):
    """The backward modes run, in order."""
    modes = []
    for name in ("_bwd_batched", "_bwd_lean"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, real=real, name=name:
                            modes.append(name) or real(*a))
    return modes


@pytest.mark.parametrize("kept", [4, 6], ids=["kept<K", "kept=K"])
@pytest.mark.parametrize("batched", [True, False], ids=["K-batched", "lean"])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_core_rnn_sum_trimmed_equals_masked(rnn_type, batched, kept,
                                            monkeypatch):
    """``core_rnn_sum`` over the first ``kept`` of K slots (``slots=K``)
    against the masked K-slot run: the output and acc's gradient (zero on
    the empty slots) bit-equal, the parameters' gradients bit-equal in the
    lean mode and within round-off in the K-batched one.  The mode gate
    reads the bank's K: a budget one byte short of the K-slot stacks keeps
    the lean mode, which the trimmed stacks alone would fit."""
    K, n, d, H = 6, 23, 10, 7
    full = 4 * K * n * (4 if rnn_type == "LSTM" else 3) * H
    budget = full if batched else full - 1
    rng = np.random.default_rng(kept)
    _, tcell = _cells(rnn_type, d, H, 4)
    acc = torch.from_numpy(rng.standard_normal((K, n, d)).astype(np.float32))
    valid = (torch.arange(K) < kept).float()
    modes = _spy_modes(monkeypatch)

    def run(trim):
        tcell.zero_grad(set_to_none=True)
        a = acc.clone().requires_grad_()
        out = (T.core_rnn_sum(tcell, a[:kept], valid[:kept], budget,
                              kept=kept, slots=K) if trim
               else T.core_rnn_sum(tcell, a, valid, budget))
        torch.tanh(out).square().sum().backward()
        return out.detach(), a.grad, dict(
            (k, p.grad) for k, p in tcell.named_parameters())

    out0, ga0, gp0 = run(False)
    out1, ga1, gp1 = run(True)
    assert modes == ["_bwd_batched" if batched else "_bwd_lean"] * 2
    assert torch.equal(out1, out0)
    assert torch.equal(ga1, ga0) and not ga1[kept:].any()
    for k, g in gp0.items():
        if batched:
            _near(gp1[k], g)
        else:
            assert torch.equal(gp1[k], g), k


def _tail_run(layer, contribs, valid, delta, xp, weight, remat=False,
              **kw):
    """``layer.tail``'s output, the products' and ``xp``'s gradients and
    the layer's, through sum(tanh(out) * weight)."""
    layer.zero_grad(set_to_none=True)
    c = contribs.clone().requires_grad_()
    x = xp.clone().requires_grad_() if delta else None

    def tail(c, x):
        return layer.tail(c, valid, delta, x, **kw)

    out = (checkpoint(tail, c, x, use_reentrant=False) if remat
           else tail(c, x))
    (torch.tanh(out) * weight).sum().backward()
    return (out.detach(), c.grad, None if x is None else x.grad,
            dict((k, p.grad) for k, p in layer.named_parameters()))


def _assert_trim_matches(got, want, valid, exact):
    out1, gc1, gx1, gp1 = got
    out0, gc0, gx0, gp0 = want
    assert torch.equal(out1, out0)
    if exact:
        assert torch.equal(gc1, gc0)
    else:
        # the K-batched backward's [K, ...] GEMMs batch fewer slots: the
        # CPU's BLAS may split the batch otherwise (CTGCN's stacked cells:
        # 1.9e-9 apart)
        _near(gc1, gc0)
    assert not gc1[~valid].any()
    if gx0 is not None:
        _near(gx1, gx0)
    for k, g in gp0.items():
        if g is None:         # the layer's own cell, where a stack ran
            assert gp1[k] is None, k
        elif exact or k.startswith("norm."):
            assert torch.equal(gp1[k], g), k
        else:
            _near(gp1[k], g)


@pytest.mark.parametrize("kept", [3, 5], ids=["kept<K", "kept=K"])
@pytest.mark.parametrize("delta, remat", [(False, False), (True, False),
                                          (False, True), (True, True)],
                         ids=["full", "delta", "full-remat", "delta-remat"])
@pytest.mark.parametrize("batched", [True, False], ids=["K-batched", "lean"])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_tail_trimmed_equals_masked(rnn_type, batched, delta, remat, kept,
                                   monkeypatch):
    """One snapshot's ``CoreDiffusion.tail`` (the prefix, plain or delta,
    then ``core_rnn_sum`` and LayerNorm), plain and under
    ``torch.utils.checkpoint``, with the host's ``kept`` against
    ``kept=None``; the counters read ``kept`` slot-steps run, all valid."""
    K, n, d, H = 5, 17, 6, 4
    gen = torch.Generator().manual_seed(kept)
    layer = TM.CoreDiffusion(d, H, rnn_type=rnn_type, generator=gen,
                             cvjp_batch_budget=T.CVJP_BATCH_BUDGET
                             if batched else 0)
    valid = torch.arange(K) < kept
    contribs = torch.randn(K, n, d, generator=gen) * valid[:, None, None]
    xp = torch.randn(n, d, generator=gen)
    weight = torch.randn(n, H, generator=gen)
    modes = _spy_modes(monkeypatch)
    want = _tail_run(layer, contribs, valid, delta, xp, weight, remat)
    steps = profiling.counter("core_rnn.slot_steps")
    valid_steps = profiling.counter("core_rnn.valid_slot_steps")
    got = _tail_run(layer, contribs, valid, delta, xp, weight, remat,
                    kept=kept)
    runs = 2 if remat else 1
    assert profiling.counter("core_rnn.slot_steps") == steps + runs * kept
    assert profiling.counter("core_rnn.valid_slot_steps") == (
        valid_steps + runs * kept)
    assert set(modes) == {"_bwd_batched" if batched else "_bwd_lean"}
    _assert_trim_matches(got, want, valid, exact=not batched)


@pytest.mark.parametrize("kept", [(3, 2, 3), (2, 2, 2)],
                         ids=["varying", "equal"])
@pytest.mark.parametrize("stacked", [False, True], ids=["CGCN", "CTGCN"])
@pytest.mark.parametrize("batched", [True, False], ids=["K-batched", "lean"])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_window_tail_trimmed_equals_masked(rnn_type, batched, stacked, kept):
    """The T-batched tail ([K, T, N, d]) runs the slots the fullest
    snapshot keeps, masked where a snapshot keeps fewer (unmasked when
    all keep as many): against ``kept=None``, with CGCN's shared cell or
    CTGCN's stacked ones; max(kept)·T slot-steps run, Σ kept valid."""
    K, Tn, n, d, H = 4, len(kept), 11, 5, 4
    gen = torch.Generator().manual_seed(sum(kept))
    budget = T.CVJP_BATCH_BUDGET if batched else 0
    layer = TM.CoreDiffusion(d, H, rnn_type=rnn_type, generator=gen,
                             cvjp_batch_budget=budget)
    cell = None
    if stacked:
        cell = T.CellStack([TM.CoreDiffusion(
            d, H, rnn_type=rnn_type, generator=gen).rnn for _ in range(Tn)])
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            setattr(cell, name, getattr(cell, name).detach()
                    .requires_grad_())
    valid = torch.arange(K)[:, None] < torch.tensor(kept)[None]    # [K, T]
    contribs = torch.randn(K, Tn, n, d, generator=gen) * valid[..., None,
                                                               None]
    weight = torch.randn(Tn, n, H, generator=gen)

    def run(k):
        if stacked:
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(cell, name).grad = None
        got = _tail_run(layer, contribs, valid, False, None, weight,
                        cell=cell, kept=k)
        if stacked:
            got[3].update((name, getattr(cell, name).grad)
                          for name in ("w_ih", "w_hh", "b_ih", "b_hh"))
        return got

    want = run(None)
    steps = profiling.counter("core_rnn.slot_steps")
    valid_steps = profiling.counter("core_rnn.valid_slot_steps")
    got = run(kept)
    assert profiling.counter("core_rnn.slot_steps") == (
        steps + max(kept) * Tn)
    assert profiling.counter("core_rnn.valid_slot_steps") == (
        valid_steps + sum(kept))
    _assert_trim_matches(got, want, valid, exact=not batched)
