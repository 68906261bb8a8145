# coding: utf-8
"""GIN, the zoo's GIN and TgGIN (port of ``BatchNorm``, ``GinMLP`` and
``GIN`` in ``ctgcn_tpu/nn/gin.py``).

A linear layer, then ``layer_num`` GIN layers: neighbor pooling (sum by
SpMM over A, which the driver gives +I when ``learn_eps`` is off; average,
the sum over the SpMM of a ones column; or max over the neighbor table),
plus ``(1 + eps_l) * h`` when ``learn_eps``, an inner MLP with BatchNorm
and ReLU between its layers, an outer BatchNorm, ReLU, and dropout between
layers.

BatchNorm normalizes with the batch's statistics (biased variance, eps
1e-5) in training and at export alike, and keeps no running statistics:
the JAX package's unsupervised path always runs the reference's
``BatchNorm1d`` in train mode.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.nn.gcn import _dropout, per_snapshot, skip_dropout
from ctgcn_torch.nn.layers import Linear
from ctgcn_torch.ops.neighbors import masked_max_pool
from ctgcn_torch.ops.spmm import spmm

POOLING_TYPES = ("sum", "average", "max")


class BatchNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.offset = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=0, keepdim=True)
        var = (x - mean).square().mean(dim=0, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.offset


class GinMLP(nn.Module):
    """The inner MLP: BatchNorm and ReLU between layers, the last linear."""

    def __init__(self, input_dim, hidden_dim, output_dim, layer_num,
                 bias=True, generator=None):
        super().__init__()
        if layer_num < 1:
            raise ValueError(f"GinMLP with {layer_num} layers")
        dims = ([input_dim, output_dim] if layer_num == 1 else
                [input_dim] + [hidden_dim] * (layer_num - 1) + [output_dim])
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], bias, generator=generator)
            for i in range(layer_num))
        self.norms = nn.ModuleList(BatchNorm(hidden_dim)
                                   for _ in range(layer_num - 1))

    def forward(self, x):
        h = x
        for lin, bn in zip(self.layers[:-1], self.norms):
            h = F.relu(bn(lin(h)))
        return self.layers[-1](h)


class GIN(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, layer_num,
                 mlp_layer_num, learn_eps=True, pooling_type="sum",
                 dropout=0.5, bias=True, generator=None):
        super().__init__()
        if pooling_type not in POOLING_TYPES:
            raise ValueError(f"pooling_type {pooling_type!r}, not one of "
                             f"{POOLING_TYPES}")
        outs = [hidden_dim] * (layer_num - 1) + [output_dim]
        self.mlps = nn.ModuleList(
            GinMLP(hidden_dim, hidden_dim, out, mlp_layer_num, bias=bias,
                   generator=generator) for out in outs)
        self.norms = nn.ModuleList(BatchNorm(out) for out in outs)
        self.linear = Linear(input_dim, hidden_dim, True, generator=generator)
        # a parameter whether or not it is learnt, as in the JAX tree
        self.eps = nn.Parameter(torch.zeros(layer_num))
        self.learn_eps = learn_eps
        self.pooling_type = pooling_type
        self.dropout = dropout

    def single(self, x, adj, nbr_t, deg_t, generator=None):
        """One snapshot: ``adj`` holds +I already when ``learn_eps`` is off
        (the driver's job)."""
        h = (self.linear.weight + self.linear.bias if x is None
             else self.linear(x))
        n_layers = len(self.mlps)
        for layer in range(n_layers):
            if self.pooling_type == "max":
                pooled = masked_max_pool(h, nbr_t, deg_t)
            else:
                pooled = spmm(adj, h)
                if self.pooling_type == "average":
                    degree = spmm(adj, h.new_ones(adj.n_rows, 1))
                    pooled = pooled / degree.clamp_min(1e-12)
            if self.learn_eps:
                pooled = pooled + (1.0 + self.eps[layer]) * h
            h = F.relu(self.norms[layer](self.mlps[layer](pooled)))
            if layer < n_layers - 1:
                h = _dropout(h, self.dropout, generator)
        return h

    def skip_draws(self, n, generator, device):
        """Draw what ``single`` draws for a snapshot of n nodes."""
        for norm in self.norms[:-1]:
            skip_dropout((n, norm.scale.shape[0]), self.dropout, generator,
                         device)

    def forward(self, xs, adjs, neighbor_data=None, generator=None,
                own=None, time_length=None):
        """xs [T, N, in] or None; adjs: T ``SparseGraph``s; neighbor_data:
        (nbr [T, N, D], deg [T, N]) for max pooling (without it every
        node pools as isolated, as in the JAX package) -> [T, N, out]
        (the ``own`` snapshots of ``time_length``: ``per_snapshot``)."""
        n, dev = adjs[0].n_rows, adjs[0].vals.device
        if neighbor_data is None:
            neighbor_data = (
                torch.zeros(len(adjs), n, 1, dtype=torch.long, device=dev),
                torch.zeros(len(adjs), n, dtype=torch.long, device=dev))
        nbr, deg = neighbor_data
        return per_snapshot(
            lambda i: self.single(None if xs is None else xs[i], adjs[i],
                                  nbr[i], deg[i], generator),
            lambda t: self.skip_draws(n, generator, dev),
            time_length or len(adjs), own)
