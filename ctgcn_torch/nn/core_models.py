# coding: utf-8
"""The CTGCN family with the k-core diffusion layers (port of
``ctgcn_tpu/nn/core_models.py``).

  * CoreDiffusion: the K slot products ``A_k @ x`` of a core pyramid on
    its backend (``slot_products``: principal blocks, dense bank, ELL/CSR
    plans, BSR plans or COO; see ``ops/pyramid.py``), masked by ``valid``;
    their prefix sum over the core axis goes through ReLU and a masked
    GRU/LSTM whose outputs are summed (``ops.rnn.core_rnn_sum``), then
    LayerNorm.  Delta-encoded ELL slots take a second prefix sum and the
    +I back as "+ x"; the blocks backend runs in core-sorted node order
    and un-permutes after the LayerNorm.
  * CGCN shares one MLP + CDN across the snapshots; CTGCN keeps
    per-timestep distinct MLP + CDN parameters, then runs one RNN over the
    time axis and a LayerNorm.  The 'S' variants also return the MLP
    output, the structure embedding of the reconstruction loss.
  * Identity node features (x = I, input_dim = N) are never materialized:
    ``xs=None`` makes each first Linear return its weight.

The bank's precision (the config's ``matmul_precision``) follows the JAX
package: a bf16 bank or bf16 blocks multiply bf16 operands into f32
results; ``dense_prec: "high"`` on an f32 bank runs three TF32 GEMMs over a
hi/lo split (the H100's counterpart of the TPU's bf16_3x); bf16 ELL plans
store the slot products in bf16, and above ``core_rnn_budget`` the prefix
too.

Memory knobs are constructor arguments with ``ctgcn_tpu``'s defaults:
``act_budget`` (window activation bytes above which each timestep's
forward is recomputed in the backward, ``torch.utils.checkpoint``),
``layer_remat`` (checkpoint each CoreDiffusion layer),
``cvjp_batch_budget`` (the K-batched mode gate of ``core_rnn_sum``) and
``core_rnn_budget`` (the bf16 prefix gate).
The T-batched window tail of the JAX package's ragged blocks path
(``_ragged_blocks_cdn_window``, off by default there) is not ported.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ctgcn_torch.nn.layers import MLP, LayerNorm, TimeRule
from ctgcn_torch.ops.bsr_spmm import pyramid_spmm
from ctgcn_torch.ops.ell import ell_spmm
from ctgcn_torch.ops.pyramid import CorePyramid, pyramid_at
from ctgcn_torch.ops.rnn import (
    CVJP_BATCH_BUDGET, GRUCell, LSTMCell, core_rnn_sum, rnn_scan)

#: default window activation budget (bytes) before per-timestep remat
ACT_BUDGET = 4 << 30
#: default budget (bytes) of one CoreDiffusion tail above which bf16 slot
#: products store the prefix in bf16 too (``_core_rnn_budget_bytes``)
CORE_RNN_BUDGET = 512 << 20


def _make_rnn(rnn_type, input_dim, hidden_dim, bias, generator):
    if rnn_type not in ("GRU", "LSTM"):
        raise ValueError(f"rnn_type {rnn_type!r}")
    cls = GRUCell if rnn_type == "GRU" else LSTMCell
    return cls(input_dim, hidden_dim, bias=bias, generator=generator)


class _Bf16MM(torch.autograd.Function):
    """``a @ b`` for a constant bf16 ``a`` and bf16 ``b``, f32 result (the
    JAX package's bf16 dot with ``preferred_element_type=f32``).  On the
    card a bf16 tensor-core GEMM with f32 output; elsewhere the operands
    are upcast, which is exact (a bf16 product fits an f32).  The backward
    gives ``a^T g`` (f32 sums) in bf16, b's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return None, (a.float().T @ g.float()).to(a.dtype)


@contextlib.contextmanager
def _tf32_matmuls():
    """TF32 for the GEMMs inside only; the flag is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tf32_split(t):
    """(hi, lo): hi is t with its mantissa cut to TF32's 10 bits (exact in
    TF32), lo = t - hi (exact in f32)."""
    hi = (t.view(torch.int32) & -8192).view(torch.float32)
    return hi, t - hi


def _mm_3xtf32(a, b):
    """``a @ b`` in f32 from three TF32 GEMMs over hi/lo splits
    (``hi·hi + (hi·lo + lo·hi)``): the H100's counterpart of the TPU's
    bf16_3x (``Precision.HIGH``), about 2^-21 relative error per product
    (the dropped lo·lo term and TF32's rounding of lo)."""
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    with _tf32_matmuls():
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


class _HighMM(torch.autograd.Function):
    """``a @ b`` by ``_mm_3xtf32`` for a constant f32 ``a``; the backward
    ``a^T g`` runs the same way (JAX's HIGH dot transposes at HIGH)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a)
        return _mm_3xtf32(a, b)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return None, _mm_3xtf32(a.T, g)


def _bank_mm(a, b, prec):
    """One bank GEMM ``a @ b`` (f32 result) at the bank's precision: bf16
    operands for a bf16 bank, else 3xTF32 ("high") or full f32."""
    if a.dtype == torch.bfloat16:
        return _Bf16MM.apply(a, b.bfloat16())
    if prec == "high":
        return _HighMM.apply(a, b)
    return a @ b


def slot_products(x, pyramid: CorePyramid):
    """The K per-slot SpMM products [K, N, d] (+I folded in unless the
    slots are delta-encoded, valid-masked) and ``xp``, the input in the
    backend's node order (the counterpart of ``CoreDiffusion._contribs``).

    f32, except on bf16 ELL plans, whose products are stored in bf16.  The
    bank GEMMs (blocks, dense) run at the bank's precision (``_bank_mm``):
    full f32 by default (no TF32), the JAX package's ``Precision.HIGHEST``.
    """
    n, K = pyramid.n_nodes, pyramid.num_slots
    backend = pyramid.backend
    xp = x
    if backend == "blocks":
        # core-sorted principal blocks: slot k's adjacency is the leading
        # nb_k x nb_k block; the node-wise stages after the products are
        # permutation-equivariant, so the layer runs in that order
        xp = x[pyramid.perm]
        parts = []
        for k in range(K):
            if k < len(pyramid.blocks):
                blk = pyramid.blocks[k]
                nb = blk.shape[0]
                r = F.pad(_bank_mm(blk, xp[:nb], pyramid.dense_prec),
                          (0, 0, 0, n - nb))
            else:
                r = xp.new_zeros(n, x.shape[1])
            # the +I on the max-core slot, as "+ x"
            parts.append(r + xp if k == 0 else r)
        contribs = torch.stack(parts)
    elif backend == "dense":
        if pyramid.dense.dtype == torch.float32 \
                and pyramid.dense_prec == "highest":
            contribs = torch.matmul(pyramid.dense, x)
        else:
            contribs = torch.stack([
                _bank_mm(pyramid.dense[k], x, pyramid.dense_prec)
                for k in range(K)])
    elif backend == "ell":
        contribs = ell_spmm(pyramid.ell_fwd, pyramid.ell_t, x,
                            bf16=pyramid.ell_bf16).reshape(K, n, -1)
    elif backend == "pallas":
        contribs = pyramid_spmm(pyramid.plan_fwd, pyramid.plan_t, x, K, n)
    else:
        # one flattened gather and index_add over all K slots
        offsets = (torch.arange(K, device=x.device) * n)[:, None]
        gathered = (x[pyramid.cols.reshape(-1)]
                    * pyramid.vals.reshape(-1)[:, None])
        contribs = x.new_zeros(K * n, x.shape[1]).index_add(
            0, (pyramid.rows + offsets).reshape(-1), gathered).reshape(
                K, n, -1)
    return contribs * pyramid.valid.to(contribs.dtype)[:, None, None], xp


def acc_in_bf16(contribs_dtype, K, n, d_in, hidden, is_lstm,
                budget=CORE_RNN_BUDGET):
    """Whether a CoreDiffusion layer stores its [K, N, d_in] prefix in
    bf16 before the core-axis RNN: when the slot products are bf16 and the
    tail's estimated footprint, 4·K·N·(2·d_in + per_h·H) bytes (per_h 7
    for a GRU, 9 for an LSTM), exceeds ``budget`` (JAX ``_tail``,
    ``ctgcn_tpu/nn/core_models.py:369-397``)."""
    per_h = 9 if is_lstm else 7
    return (contribs_dtype == torch.bfloat16
            and 4 * K * n * (2 * d_in + per_h * hidden) > budget)


class CoreDiffusion(nn.Module):
    """K-core diffusion layer: h_k = h_{k-1} + A_k @ x over the valid core
    slots (max core first), ReLU, a core-axis RNN whose outputs are summed,
    then LayerNorm."""

    def __init__(self, input_dim, output_dim, bias=True, rnn_type="GRU",
                 generator=None, cvjp_batch_budget=CVJP_BATCH_BUDGET,
                 core_rnn_budget=CORE_RNN_BUDGET):
        super().__init__()
        self.rnn = _make_rnn(rnn_type, input_dim, output_dim, bias, generator)
        self.norm = LayerNorm(output_dim)
        self.cvjp_batch_budget = cvjp_batch_budget
        self.core_rnn_budget = core_rnn_budget

    def forward(self, x, pyramid: CorePyramid):
        contribs, xp = slot_products(x.float(), pyramid)
        # the k-core prefix in f32 (the JAX package's _prefix_acc, a lower-
        # triangular matmul there); delta slots hold A_k - A_{k-1}, so the
        # slot products are themselves a prefix: (L L) @ contribs + x
        acc = torch.cumsum(contribs.float(), dim=0)
        if pyramid.backend == "ell" and pyramid.ell_delta:
            acc = torch.cumsum(acc, dim=0) + xp
        K, n, d_in = contribs.shape
        if acc_in_bf16(contribs.dtype, K, n, d_in, self.rnn.hidden_dim,
                       self.rnn.is_lstm, self.core_rnn_budget):
            acc = acc.bfloat16()
        out = self.norm(core_rnn_sum(self.rnn, acc, pyramid.valid.float(),
                                     self.cvjp_batch_budget))
        if pyramid.backend == "blocks":
            out = out[pyramid.inv_perm]
        return out


class CDN(nn.Module):
    """A stack of CoreDiffusion layers."""

    def __init__(self, input_dim, hidden_dim, output_dim, diffusion_num,
                 bias=True, rnn_type="GRU", generator=None, layer_remat=False,
                 cvjp_batch_budget=CVJP_BATCH_BUDGET,
                 core_rnn_budget=CORE_RNN_BUDGET):
        super().__init__()
        if diffusion_num < 1:
            raise ValueError("diffusion_num must be >= 1")
        if diffusion_num == 1:
            dims = [(input_dim, output_dim)]
        else:
            dims = ([(input_dim, hidden_dim)]
                    + [(hidden_dim, hidden_dim)] * (diffusion_num - 2)
                    + [(hidden_dim, output_dim)])
        self.layers = nn.ModuleList(
            CoreDiffusion(d_in, d_out, bias=bias, rnn_type=rnn_type,
                          generator=generator,
                          cvjp_batch_budget=cvjp_batch_budget,
                          core_rnn_budget=core_rnn_budget)
            for d_in, d_out in dims)
        self.layer_remat = layer_remat

    def forward(self, x, pyramid):
        for layer in self.layers:
            if self.layer_remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, pyramid, use_reentrant=False)
            else:
                x = layer(x, pyramid)
        return x


def _window_act_bytes(cdn: CDN, pyramids: CorePyramid):
    """Rough forward-activation footprint of the window: the [K, N, d_in]
    contribs/prefix/relu plus [K, N, 3H+H] GRU tensors per layer."""
    T, K = pyramids.valid.shape
    per_node = sum(3 * layer.rnn.w_ih.shape[-1] + 4 * layer.rnn.w_hh.shape[-1]
                   for layer in cdn.layers)
    return 4 * T * K * pyramids.n_nodes * per_node


def _over_window(step, xs, pyramids: CorePyramid, cdn: CDN, act_budget):
    """``step(t, x_t, pyramid_t)`` for every snapshot of the window (x_t
    None for identity features).  Above the activation budget each
    snapshot's forward is recomputed in the backward, so the backward
    holds one snapshot at a time.  Returns the list of step outputs."""
    T = pyramids.valid.shape[0]
    remat = (torch.is_grad_enabled()
             and _window_act_bytes(cdn, pyramids) > act_budget)
    outs = []
    for t in range(T):
        def per_t(x, t=t):
            return step(t, x, pyramid_at(pyramids, t))

        x = None if xs is None else xs[t]
        outs.append(checkpoint(per_t, x, use_reentrant=False) if remat
                    else per_t(x))
    return outs


def _stack_outs(outs, model_type):
    """[T, N, out], or (embs, trans) stacked for the 'S' variant."""
    if model_type == "S":
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return torch.stack(outs)


def _mlp(model_type, input_dim, hidden_dim, output_dim, trans_num, bias,
         trans_activate_type, generator):
    """A snapshot's MLP: 'C' in -> hid, 'S' in -> hid -> out."""
    if model_type not in ("C", "S"):
        raise ValueError(f"model_type {model_type!r}")
    return MLP(input_dim, hidden_dim,
               hidden_dim if model_type == "C" else output_dim, trans_num,
               bias=bias, activate_type=trans_activate_type,
               generator=generator)


def _cdn(model_type, hidden_dim, output_dim, diffusion_num, **kw):
    """A snapshot's CDN: 'C' hid -> out, 'S' out -> out."""
    return CDN(hidden_dim if model_type == "C" else output_dim, output_dim,
               output_dim, diffusion_num, **kw)


class CGCN(nn.Module):
    """Static k-core GCN: one MLP + CDN shared by every snapshot of the
    window ('C': MLP(in -> hid), CDN(hid -> out); 'S': MLP(in -> hid ->
    out), CDN(out -> out)).  Returns [T, N, out], or (embs, trans) for
    'S', trans being the MLP output (the structure embedding)."""

    def __init__(self, input_dim, hidden_dim, output_dim, trans_num,
                 diffusion_num, bias=True, rnn_type="GRU", model_type="C",
                 trans_activate_type="L", generator=None,
                 act_budget=ACT_BUDGET, layer_remat=False,
                 cvjp_batch_budget=CVJP_BATCH_BUDGET,
                 core_rnn_budget=CORE_RNN_BUDGET):
        super().__init__()
        self.mlp = _mlp(model_type, input_dim, hidden_dim, output_dim,
                        trans_num, bias, trans_activate_type, generator)
        self.cdn = _cdn(model_type, hidden_dim, output_dim, diffusion_num,
                        bias=bias, rnn_type=rnn_type, generator=generator,
                        layer_remat=layer_remat,
                        cvjp_batch_budget=cvjp_batch_budget,
                        core_rnn_budget=core_rnn_budget)
        self.model_type = model_type
        self.act_budget = act_budget

    def forward(self, xs, pyramids: CorePyramid):
        def step(t, x, pyramid):
            trans = self.mlp(x)
            emb = self.cdn(trans, pyramid)
            return (emb, trans) if self.model_type == "S" else emb

        return _stack_outs(_over_window(step, xs, pyramids, self.cdn,
                                        self.act_budget), self.model_type)


class CTGCN(nn.Module):
    """Temporal k-core GCN: per timestep an MLP and a CDN with their own
    parameters (the shapes of ``CGCN``'s variant), then one time-axis RNN
    and LayerNorm.  Returns [T, N, out], or (out, trans) for 'S'."""

    time_rule = TimeRule(("mlps", "cdns"), ("rnn", "norm"))

    def __init__(self, input_dim, hidden_dim, output_dim, trans_num,
                 diffusion_num, duration, bias=True, rnn_type="GRU",
                 model_type="C", trans_activate_type="L", generator=None,
                 act_budget=ACT_BUDGET, layer_remat=False,
                 cvjp_batch_budget=CVJP_BATCH_BUDGET,
                 core_rnn_budget=CORE_RNN_BUDGET):
        super().__init__()
        self.mlps = nn.ModuleList(
            _mlp(model_type, input_dim, hidden_dim, output_dim, trans_num,
                 bias, trans_activate_type, generator)
            for _ in range(duration))
        self.cdns = nn.ModuleList(
            _cdn(model_type, hidden_dim, output_dim, diffusion_num,
                 bias=bias, rnn_type=rnn_type, generator=generator,
                 layer_remat=layer_remat,
                 cvjp_batch_budget=cvjp_batch_budget,
                 core_rnn_budget=core_rnn_budget)
            for _ in range(duration))
        self.rnn = _make_rnn(rnn_type, output_dim, output_dim, bias,
                             generator)
        self.norm = LayerNorm(output_dim)
        self.duration = duration
        self.model_type = model_type
        self.act_budget = act_budget

    def per_timestep(self, xs, pyramids: CorePyramid):
        """Per-timestep MLP + CDN stacks over the window: [T, N, out]
        (and the MLP outputs [T, N, out] for 'S')."""
        def step(t, x, pyramid):
            trans = self.mlps[t](x)
            emb = self.cdns[t](trans, pyramid)
            return (emb, trans) if self.model_type == "S" else emb

        return _stack_outs(_over_window(step, xs, pyramids, self.cdns[0],
                                        self.act_budget), self.model_type)

    def forward(self, xs, pyramids: CorePyramid):
        res = self.per_timestep(xs, pyramids)
        hx = res[0] if self.model_type == "S" else res
        outs, _ = rnn_scan(self.rnn, hx)
        out = self.norm(outs)
        return (out, res[1]) if self.model_type == "S" else out
