# coding: utf-8
"""GCN (Kipf & Welling), the zoo's GCN and TgGCN, and GCRN (port of
``GraphConvolution``, ``GCN`` and ``GCRN`` in ``ctgcn_tpu/nn/gcn.py``).

The convolution is ``spmm(adj, x @ W) + b``; with identity features the
support is ``W`` itself.  One set of parameters serves every snapshot of
the window in GCN; GCRN has a GCN of its own for each timestep (the JAX
package stacks their leaves on a leading [T] axis), then an L2 row
normalization, a GRU or LSTM over time and a LayerNorm.
``GraphConvolution`` draws U(-1/sqrt(out_dim), 1/sqrt(out_dim)) for weight
and bias: out_dim, unlike ``torch.nn.Linear``.  Dropout draws its mask from
the ``generator`` passed in (the engine's; GCRN's steps draw one after
another), and is off without one (the export).

A time part runs the per-snapshot forwards on its own snapshots only
(``own``, a range of the window's ``time_length`` timesteps; all of them
by default) and draws, for every other snapshot in window order, what its
forward would draw (``skip_draws``), so that a part's generator gives what
one device's gives (``per_snapshot``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.nn.core_models import _make_rnn
from ctgcn_torch.nn.layers import LayerNorm, TimeRule
from ctgcn_torch.ops.rnn import rnn_scan
from ctgcn_torch.ops.spmm import spmm


def _dropout(x, rate, generator):
    """Inverted dropout: keep each entry with probability 1 - rate, scaled
    by 1 / (1 - rate); nothing without a generator or at rate 0."""
    if generator is None or not rate:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def skip_dropout(shape, rate, generator, device):
    """Draw from ``generator`` what ``_dropout`` draws for a tensor of
    ``shape`` on ``device``, and nothing else (a time part's generator
    passes another part's snapshot this way)."""
    if generator is not None and rate:
        torch.rand(shape, generator=generator, device=device)


def per_snapshot(single, skip, time_length, own=None):
    """``single(i)`` stacked over the snapshots the caller holds, i counted
    from 0: all ``time_length`` of the window, or those whose timesteps
    lie in the range ``own`` (a time part's), with ``skip(t)`` called in
    window order for every other timestep t, to draw what its snapshot's
    forward draws."""
    own = range(time_length) if own is None else own
    outs = []
    for t in range(time_length):
        if t in own:
            outs.append(single(t - own.start))
        else:
            skip(t)
    return torch.stack(outs)


class GraphConvolution(nn.Module):
    def __init__(self, input_dim, output_dim, bias=True, generator=None):
        super().__init__()
        stdv = 1.0 / math.sqrt(output_dim)

        def uniform(*shape):
            return nn.Parameter(
                (torch.rand(*shape, generator=generator) * 2 - 1) * stdv)

        self.weight = uniform(input_dim, output_dim)
        self.bias = uniform(output_dim) if bias else None

    def forward(self, x, adj):
        """x [N, in] or None (identity features) -> [N, out]."""
        support = self.weight if x is None else x @ self.weight
        out = spmm(adj, support)
        return out if self.bias is None else out + self.bias


class GCN(nn.Module):
    """Two graph convolutions, ReLU and dropout between them."""

    def __init__(self, input_dim, hidden_dim, output_dim, dropout=0.5,
                 bias=True, generator=None):
        super().__init__()
        self.gc1 = GraphConvolution(input_dim, hidden_dim, bias, generator)
        self.gc2 = GraphConvolution(hidden_dim, output_dim, bias, generator)
        self.dropout = dropout if dropout is not None else 0.0

    def single(self, x, adj, generator=None):
        h = F.relu(self.gc1(x, adj))
        h = _dropout(h, self.dropout, generator)
        return self.gc2(h, adj)

    def skip_draws(self, n, generator, device):
        """Draw what ``single`` draws for a snapshot of n nodes."""
        skip_dropout((n, self.gc1.weight.shape[1]), self.dropout, generator,
                     device)

    def forward(self, xs, adjs, generator=None, own=None, time_length=None):
        """xs [T, N, in] or None; adjs: T ``SparseGraph``s -> [T, N, out]
        (the ``own`` snapshots of ``time_length``: ``per_snapshot``)."""
        n, dev = adjs[0].n_rows, adjs[0].vals.device
        return per_snapshot(
            lambda i: self.single(None if xs is None else xs[i], adjs[i],
                                  generator),
            lambda t: self.skip_draws(n, generator, dev),
            time_length or len(adjs), own)


class GCRN(nn.Module):
    """One ``GCN`` per timestep (``duration`` of them), each output row
    divided by max(its L2 norm, 1e-12), then a GRU or LSTM (``rnn_type``)
    over time and a LayerNorm."""

    time_rule = TimeRule(("gcns",), ("rnn", "norm"))

    def __init__(self, input_dim, hidden_dim, output_dim, duration,
                 dropout=0.5, bias=True, rnn_type="GRU", generator=None):
        super().__init__()
        self.gcns = nn.ModuleList(
            GCN(input_dim, hidden_dim, output_dim, dropout=dropout,
                bias=bias, generator=generator) for _ in range(duration))
        self.rnn = _make_rnn(rnn_type, output_dim, output_dim, bias,
                             generator)
        self.norm = LayerNorm(output_dim)

    def forward(self, xs, adjs, generator=None, own=None, time_length=None,
                gather=None):
        """xs [T, N, in] or None; adjs: T ``SparseGraph``s -> [T, N, out].
        A time part holds the GCNs, xs and adjs of its ``own`` snapshots
        (``per_snapshot``); ``gather`` then assembles their normalized
        outputs over T before the time RNN."""
        if len(self.gcns) != len(adjs):
            raise ValueError(f"{len(self.gcns)} GCNs, {len(adjs)} graphs")
        n, dev = adjs[0].n_rows, adjs[0].vals.device
        hx = per_snapshot(
            lambda i: F.normalize(self.gcns[i].single(
                None if xs is None else xs[i], adjs[i], generator),
                dim=1, eps=1e-12),
            lambda t: self.gcns[0].skip_draws(n, generator, dev),
            time_length or len(adjs), own)
        if gather is not None:
            hx = gather(hx)
        outs, _ = rnn_scan(self.rnn, hx)
        return self.norm(outs)
