# coding: utf-8
"""CTGCN with the k-core diffusion layers (port of
``ctgcn_tpu/nn/core_models.py``, BSR-plan backend).

  * CoreDiffusion: the K slot products ``A_k @ x`` of a core pyramid run as
    one block-sparse product (``ops.bsr_spmm.pyramid_spmm``; +I is already
    in slot 0's plan), masked by ``valid``; their prefix sum over the core
    axis goes through ReLU and a masked GRU/LSTM whose outputs are summed
    (``ops.rnn.core_rnn_sum``), then LayerNorm.
  * CTGCN keeps per-timestep distinct MLP + CDN parameters, then runs one
    RNN over the time axis and a LayerNorm.
  * Identity node features (x = I, input_dim = N) are never materialized:
    ``xs=None`` makes each first Linear return its weight.

Memory knobs are constructor arguments with ``ctgcn_tpu``'s defaults:
``act_budget`` (window activation bytes above which each timestep's
forward is recomputed in the backward, ``torch.utils.checkpoint``),
``layer_remat`` (checkpoint each CoreDiffusion layer) and
``cvjp_batch_budget`` (the K-batched mode gate of ``core_rnn_sum``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctgcn_torch.nn.layers import MLP, LayerNorm
from ctgcn_torch.ops.bsr_spmm import pyramid_spmm
from ctgcn_torch.ops.pyramid import CorePyramid, pyramid_at
from ctgcn_torch.ops.rnn import (
    CVJP_BATCH_BUDGET, GRUCell, LSTMCell, core_rnn_sum, rnn_scan)

#: default window activation budget (bytes) before per-timestep remat
ACT_BUDGET = 4 << 30


def _make_rnn(rnn_type, input_dim, hidden_dim, bias, generator):
    if rnn_type not in ("GRU", "LSTM"):
        raise ValueError(f"rnn_type {rnn_type!r}")
    cls = GRUCell if rnn_type == "GRU" else LSTMCell
    return cls(input_dim, hidden_dim, bias=bias, generator=generator)


class CoreDiffusion(nn.Module):
    """K-core diffusion layer: h_k = h_{k-1} + A_k @ x over the valid core
    slots (max core first), ReLU, a core-axis RNN whose outputs are summed,
    then LayerNorm."""

    def __init__(self, input_dim, output_dim, bias=True, rnn_type="GRU",
                 generator=None, cvjp_batch_budget=CVJP_BATCH_BUDGET):
        super().__init__()
        self.rnn = _make_rnn(rnn_type, input_dim, output_dim, bias, generator)
        self.norm = LayerNorm(output_dim)
        self.cvjp_batch_budget = cvjp_batch_budget

    def forward(self, x, pyramid: CorePyramid):
        valid = pyramid.valid.float()
        contribs = pyramid_spmm(pyramid.plan_fwd, pyramid.plan_t, x.float(),
                                pyramid.num_slots, pyramid.n_nodes)
        contribs = contribs * valid[:, None, None]
        # the k-core prefix (the JAX package's _prefix_acc, a lower-
        # triangular matmul there)
        acc = torch.cumsum(contribs, dim=0)
        out = core_rnn_sum(self.rnn, acc, valid, self.cvjp_batch_budget)
        return self.norm(out)


class CDN(nn.Module):
    """A stack of CoreDiffusion layers."""

    def __init__(self, input_dim, hidden_dim, output_dim, diffusion_num,
                 bias=True, rnn_type="GRU", generator=None, layer_remat=False,
                 cvjp_batch_budget=CVJP_BATCH_BUDGET):
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
                          cvjp_batch_budget=cvjp_batch_budget)
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


class CTGCN(nn.Module):
    """Temporal k-core GCN, 'C' variant: per timestep MLP(in -> hid) and
    CDN(hid -> out) with their own parameters, then one time-axis RNN and
    LayerNorm.  Returns [T, N, out]."""

    def __init__(self, input_dim, hidden_dim, output_dim, trans_num,
                 diffusion_num, duration, bias=True, rnn_type="GRU",
                 model_type="C", trans_activate_type="L", generator=None,
                 act_budget=ACT_BUDGET, layer_remat=False,
                 cvjp_batch_budget=CVJP_BATCH_BUDGET):
        super().__init__()
        if model_type != "C":
            raise NotImplementedError(
                "CTGCN-S is not ported yet (ROADMAP.md queue 1, item 9)")
        self.mlps = nn.ModuleList(
            MLP(input_dim, hidden_dim, hidden_dim, trans_num, bias=bias,
                activate_type=trans_activate_type, generator=generator)
            for _ in range(duration))
        self.cdns = nn.ModuleList(
            CDN(hidden_dim, output_dim, output_dim, diffusion_num, bias=bias,
                rnn_type=rnn_type, generator=generator,
                layer_remat=layer_remat, cvjp_batch_budget=cvjp_batch_budget)
            for _ in range(duration))
        self.rnn = _make_rnn(rnn_type, output_dim, output_dim, bias,
                             generator)
        self.norm = LayerNorm(output_dim)
        self.duration = duration
        self.act_budget = act_budget

    def per_timestep(self, xs, pyramids: CorePyramid):
        """Per-timestep MLP + CDN stacks over the window: [T, N, out].
        Above the activation budget each timestep's forward is recomputed
        in the backward, so the backward holds one snapshot at a time."""
        T = pyramids.valid.shape[0]
        remat = (torch.is_grad_enabled()
                 and _window_act_bytes(self.cdns[0], pyramids)
                 > self.act_budget)
        outs = []
        for t in range(T):
            def per_t(x, t=t):
                return self.cdns[t](self.mlps[t](x), pyramid_at(pyramids, t))

            x = None if xs is None else xs[t]
            outs.append(checkpoint(per_t, x, use_reentrant=False) if remat
                        else per_t(x))
        return torch.stack(outs)

    def forward(self, xs, pyramids: CorePyramid):
        hx = self.per_timestep(xs, pyramids)
        outs, _ = rnn_scan(self.rnn, hx)
        return self.norm(outs)
