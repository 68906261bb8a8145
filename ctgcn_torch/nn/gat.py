# coding: utf-8
"""Sparse GAT, the zoo's GAT and TgGAT (port of ``SpGraphAttentionLayer``
and ``GAT`` in ``ctgcn_tpu/nn/gat.py``).

Per edge (i, j) of the adjacency a layer computes the logit
``a . [h_i ; h_j]`` and ``e = exp(-leakyrelu(logit, alpha))``, with no
shift by a maximum; the row sums of e, then edge dropout on e, then
``h' = E @ h / max(rowsum, 1e-12)`` and ELU between layers.  The
adjacency's values are never read: only its structure counts, so GAT's
D^-1 (A + I) means self-loops and nothing else, and a node without edges
(TgGAT has no self-loops) comes out as a zero row.  The row sum is taken
before the dropout, as in the JAX package, so h' divides the dropped-out
sum by the sum of the values before dropout.

Both products run through ``ell_spmm_ev`` on the kernels when the graph
carries its plans (``EvPlan``s), else through the segment ``spmm_ev``.  The
row sum multiplies a ones column, which needs no gradient, so its
backward computes d(vals) alone.

Init: xavier_normal with gain 1.414 for ``W`` and ``a``, ``a`` drawn as
[1, 2 out] and row 0 kept.  Dropout draws its masks from the generator
passed in, and is off without one (the export); features get no input
dropout when they are the identity.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.nn.gcn import _dropout, per_snapshot, skip_dropout
from ctgcn_torch.ops.ell import ell_spmm_ev
from ctgcn_torch.ops.spmm import spmm_ev


def _xavier_normal(shape, generator, gain=1.414):
    std = gain * math.sqrt(2.0 / (shape[0] + shape[1]))
    return std * torch.randn(*shape, generator=generator)


class SpGraphAttentionLayer(nn.Module):
    def __init__(self, in_features, out_features, dropout, alpha,
                 concat=True, generator=None):
        super().__init__()
        self.W = nn.Parameter(_xavier_normal((in_features, out_features),
                                             generator))
        self.a = nn.Parameter(_xavier_normal((1, 2 * out_features),
                                             generator)[0])
        self.alpha = alpha
        self.concat = concat
        self.dropout = dropout

    def forward(self, x, adj, generator=None):
        """x [N, in] or None (identity features) -> [N, out]."""
        h = self.W if x is None else x @ self.W
        out = h.shape[1]
        src, dst = adj.rows, adj.cols
        logit = (h @ self.a[:out])[src] + (h @ self.a[out:])[dst]
        edge_e = torch.exp(-F.leaky_relu(logit, self.alpha))
        ones = h.new_ones(adj.n_rows, 1)
        if adj.plan_fwd is not None:
            def product(vals, x_):
                return ell_spmm_ev(adj, vals, x_)
        else:
            def product(vals, x_):
                return spmm_ev(src, dst, vals, x_, adj.n_rows)
        rowsum = product(edge_e, ones)
        edge_e = _dropout(edge_e, self.dropout, generator)
        h_prime = product(edge_e, h) / rowsum.clamp_min(1e-12)
        return F.elu(h_prime) if self.concat else h_prime


class GAT(nn.Module):
    """``head_num`` attention layers concatenated, then one output layer;
    ``learning_type == "U-neg"`` ends in ``log_softmax``, so the exported
    embeddings are log-probabilities."""

    def __init__(self, input_dim, hidden_dim, output_dim, dropout=0.6,
                 alpha=0.2, head_num=8, learning_type="U-neg",
                 generator=None):
        super().__init__()
        self.attentions = nn.ModuleList(
            SpGraphAttentionLayer(input_dim, hidden_dim, dropout, alpha,
                                  concat=True, generator=generator)
            for _ in range(head_num))
        self.out_att = SpGraphAttentionLayer(
            hidden_dim * head_num, output_dim, dropout, alpha, concat=False,
            generator=generator)
        self.dropout = dropout
        self.learning_type = learning_type

    def single(self, x, adj, generator=None):
        if x is not None:
            x = _dropout(x, self.dropout, generator)
        h = torch.cat([att(x, adj, generator) for att in self.attentions],
                      dim=1)
        h = _dropout(h, self.dropout, generator)
        h = F.elu(self.out_att(h, adj, generator))
        if self.learning_type == "U-neg":
            return F.log_softmax(h, dim=1)
        return h

    def skip_draws(self, n, n_edges, generator, device, in_dim=None):
        """Draw what ``single`` draws for a snapshot of n nodes and
        ``n_edges`` stored edges, given features of width ``in_dim`` (None:
        identity features)."""
        if in_dim is not None:
            skip_dropout((n, in_dim), self.dropout, generator, device)
        for att in self.attentions:
            skip_dropout((n_edges,), att.dropout, generator, device)
        skip_dropout((n, sum(att.W.shape[1] for att in self.attentions)),
                     self.dropout, generator, device)
        skip_dropout((n_edges,), self.out_att.dropout, generator, device)

    def forward(self, xs, adjs, generator=None, own=None, time_length=None,
                edge_counts=None):
        """xs [T, N, in] or None; adjs: T ``SparseGraph``s -> [T, N, out]
        (the ``own`` snapshots of ``time_length``: ``per_snapshot``; every
        snapshot's stored edge count ``edge_counts[t]`` sizes the edge
        dropout of the others)."""
        n, dev = adjs[0].n_rows, adjs[0].vals.device
        in_dim = None if xs is None else xs.shape[-1]
        return per_snapshot(
            lambda i: self.single(None if xs is None else xs[i], adjs[i],
                                  generator),
            lambda t: self.skip_draws(n, int(edge_counts[t]), generator, dev,
                                      in_dim),
            time_length or len(adjs), own)
