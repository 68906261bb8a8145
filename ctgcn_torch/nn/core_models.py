# coding: utf-8
"""CTGCN with the k-core diffusion layers (port of
``ctgcn_tpu/nn/core_models.py``).

  * CoreDiffusion: the K slot products ``A_k @ x`` of a core pyramid on
    its backend (``slot_products``: principal blocks, dense bank, ELL/CSR
    plans, BSR plans or COO; see ``ops/pyramid.py``), masked by ``valid``;
    their prefix sum over the core axis goes through ReLU and a masked
    GRU/LSTM whose outputs are summed (``ops.rnn.core_rnn_sum``), then
    LayerNorm.  Delta-encoded ELL slots take a second prefix sum and the
    +I back as "+ x"; the blocks backend runs in core-sorted node order
    and un-permutes after the LayerNorm.
  * CTGCN keeps per-timestep distinct MLP + CDN parameters, then runs one
    RNN over the time axis and a LayerNorm.
  * Identity node features (x = I, input_dim = N) are never materialized:
    ``xs=None`` makes each first Linear return its weight.

Memory knobs are constructor arguments with ``ctgcn_tpu``'s defaults:
``act_budget`` (window activation bytes above which each timestep's
forward is recomputed in the backward, ``torch.utils.checkpoint``),
``layer_remat`` (checkpoint each CoreDiffusion layer) and
``cvjp_batch_budget`` (the K-batched mode gate of ``core_rnn_sum``).
The T-batched window tail of the JAX package's ragged blocks path
(``_ragged_blocks_cdn_window``, off by default there) is not ported.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ctgcn_torch.nn.layers import MLP, LayerNorm
from ctgcn_torch.ops.bsr_spmm import pyramid_spmm
from ctgcn_torch.ops.ell import ell_spmm
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


def slot_products(x, pyramid: CorePyramid):
    """The K per-slot SpMM products [K, N, d] (f32, +I folded in unless the
    slots are delta-encoded, valid-masked) and ``xp``, the input in the
    backend's node order (the counterpart of ``CoreDiffusion._contribs``).

    GEMMs run in full f32 (no TF32), the JAX package's
    ``Precision.HIGHEST``."""
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
                r = F.pad(blk @ xp[:nb], (0, 0, 0, n - nb))
            else:
                r = xp.new_zeros(n, x.shape[1])
            # the +I on the max-core slot, as "+ x"
            parts.append(r + xp if k == 0 else r)
        contribs = torch.stack(parts)
    elif backend == "dense":
        contribs = torch.matmul(pyramid.dense, x)
    elif backend == "ell":
        contribs = ell_spmm(pyramid.ell_fwd, pyramid.ell_t, x).reshape(
            K, n, -1)
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
    return contribs * pyramid.valid.float()[:, None, None], xp


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
        contribs, xp = slot_products(x.float(), pyramid)
        # the k-core prefix (the JAX package's _prefix_acc, a lower-
        # triangular matmul there); delta slots hold A_k - A_{k-1}, so the
        # slot products are themselves a prefix: (L L) @ contribs + x
        acc = torch.cumsum(contribs, dim=0)
        if pyramid.backend == "ell" and pyramid.ell_delta:
            acc = torch.cumsum(acc, dim=0) + xp
        out = self.norm(core_rnn_sum(self.rnn, acc, pyramid.valid.float(),
                                     self.cvjp_batch_budget))
        if pyramid.backend == "blocks":
            out = out[pyramid.inv_perm]
        return out


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
