# coding: utf-8
"""GraphSAGE, the zoo's SAGE and TgSAGE (port of ``SAGELayer`` and
``SAGE`` in ``ctgcn_tpu/nn/sage.py``).

A linear layer (on identity features its weight plus its bias), then two
SAGE layers: each samples its neighbours from the window's neighbour
table (``sample_neighbors``; all of them when ``num_sample`` is None),
pools them by sum, average or max, and applies Linear, ReLU and a row L2
normalisation (floor 1e-12) to ``[self || neigh]`` (to ``neigh`` alone
with ``gcn``); dropout between the two layers.

Sampling needs random numbers even at export: without a generator the
model draws from one seeded 0 on the data's device, as the JAX model
draws from ``jax.random.key(0)``.  So an export samples its neighbours
and applies the dropout between the layers, the same draws each time.

Pooling over all neighbours (``num_sample`` None, what every config's
SAGE entry gives) is a gather over the table's valid slots and an
``index_add_`` into their rows for sum and average, so that no [N, D, d]
gather is made; max pooling and the sampled [N, S] case gather
``x[idx]``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.nn.gcn import _dropout, per_snapshot, skip_dropout
from ctgcn_torch.nn.layers import Linear
from ctgcn_torch.ops.neighbors import sample_neighbors

POOLING_TYPES = ("sum", "average", "max")


def _pool(x, idx, mask, pooling_type):
    """Pool x over each row's neighbours ``idx`` [N, S] where ``mask``;
    a row with none pools to zeros."""
    if pooling_type == "max":
        feats = x[idx].masked_fill(~mask[:, :, None], float("-inf"))
        return torch.where(mask.any(1, keepdim=True), feats.amax(1),
                           torch.zeros((), dtype=x.dtype, device=x.device))
    rows, slots = mask.nonzero(as_tuple=True)
    neigh = x.new_zeros(x.shape[0], x.shape[1]).index_add_(
        0, rows, x[idx[rows, slots]])
    if pooling_type == "average":
        neigh = neigh / mask.sum(1, keepdim=True).clamp_min(1)
    return neigh


class SAGELayer(nn.Module):
    def __init__(self, input_dim, output_dim, num_sample=10,
                 pooling_type="sum", gcn=False, bias=True, generator=None):
        super().__init__()
        if pooling_type not in POOLING_TYPES:
            raise ValueError(f"pooling_type {pooling_type!r}, not one of "
                             f"{POOLING_TYPES}")
        self.linear = Linear(input_dim if gcn else 2 * input_dim, output_dim,
                             bias, generator=generator)
        self.num_sample = num_sample
        self.pooling_type = pooling_type
        self.gcn = gcn

    def forward(self, x, nbr_t, deg_t, generator):
        if self.num_sample is None:
            idx = nbr_t
            mask = (torch.arange(nbr_t.shape[1], device=nbr_t.device)[None, :]
                    < deg_t[:, None])
        else:
            idx, mask = sample_neighbors(nbr_t, deg_t, self.num_sample,
                                         generator)
        neigh = _pool(x, idx, mask, self.pooling_type)
        combined = neigh if self.gcn else torch.cat([x, neigh], dim=1)
        h = F.relu(self.linear(combined))
        return h / h.norm(dim=1, keepdim=True).clamp_min(1e-12)


class SAGE(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, num_sample=10,
                 pooling_type="sum", gcn=False, dropout=0.5, bias=True,
                 generator=None):
        super().__init__()
        self.linear = Linear(input_dim, hidden_dim, bias, generator=generator)
        self.sage1 = SAGELayer(hidden_dim, hidden_dim, num_sample,
                               pooling_type, gcn, bias, generator)
        self.sage2 = SAGELayer(hidden_dim, output_dim, num_sample,
                               pooling_type, gcn, bias, generator)
        self.dropout = dropout

    def single(self, x, nbr_t, deg_t, generator):
        if x is None:
            lin = self.linear
            h = lin.weight if lin.bias is None else lin.weight + lin.bias
        else:
            h = self.linear(x)
        h = self.sage1(h, nbr_t, deg_t, generator)
        h = _dropout(h, self.dropout, generator)
        return self.sage2(h, nbr_t, deg_t, generator)

    def skip_draws(self, n, width, generator, device):
        """Draw what ``single`` draws for a snapshot of n nodes whose
        neighbour table is ``width`` wide."""
        for layer in (self.sage1, self.sage2):
            if layer.num_sample is not None:
                torch.rand((n, width), generator=generator, device=device)
            if layer is self.sage1:
                skip_dropout((n, layer.linear.weight.shape[1]), self.dropout,
                             generator, device)

    def forward(self, xs, neighbor_data, generator=None, own=None,
                time_length=None):
        """xs [T, N, in] or None; neighbor_data (nbr [T, N, D], deg [T, N])
        -> [T, N, out] (the ``own`` snapshots of ``time_length``:
        ``per_snapshot``).  Draws from a generator seeded 0 when none is
        given."""
        nbr, deg = neighbor_data
        if generator is None:
            generator = torch.Generator(device=nbr.device).manual_seed(0)
        return per_snapshot(
            lambda i: self.single(None if xs is None else xs[i], nbr[i],
                                  deg[i], generator),
            lambda t: self.skip_draws(nbr.shape[1], nbr.shape[2], generator,
                                      nbr.device),
            time_length or nbr.shape[0], own)
