# coding: utf-8
"""EvolveGCN (port of ``ctgcn_tpu/nn/egcn.py``): two ``GRCU`` layers whose
GCN weight evolves over time through a matrix GRU.  EGCNH summarizes the
step's node features by ``TopK`` (k = the layer's output width) to drive
the GRU; EGCNO feeds the weight itself back.  A step computes
``rrelu(A @ (x @ W_t))`` on the zoo's ``spmm``, so on graphs that carry
their plans it runs the CUDA kernels, the backward on the transpose plan.

The JAX ``lax.scan`` over time is a Python loop carrying the weight.
rrelu's negative slope is (1/8 + 1/3) / 2 without a generator (the
export); with one (the engine's) each element draws its own slope from
U(1/8, 1/3), never from the global RNG.  There is no bias outside the
GRU gates and no dropout.  Init: a gate's ``W`` and ``U`` U(+-1/sqrt(rows)),
its ``bias`` [rows, cols] U(+-1/sqrt(cols)); ``TopK.scorer`` [feats, 1]
U(+-1/sqrt(feats)); ``GCN_init_weights`` [in, out] U(+-1/sqrt(out)).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ctgcn_torch.ops.spmm import spmm

_RRELU_LO, _RRELU_HI = 1.0 / 8.0, 1.0 / 3.0


def _rrelu(x, generator=None):
    """x where x >= 0 (so a gradient of 1 at 0), else slope * x."""
    if generator is None:
        slope = (_RRELU_LO + _RRELU_HI) / 2.0
    else:
        slope = _RRELU_LO + (_RRELU_HI - _RRELU_LO) * torch.rand(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return torch.where(x >= 0, x, slope * x)


def _uniform(shape, bound, generator):
    return nn.Parameter((torch.rand(*shape, generator=generator) * 2 - 1)
                        * bound)


class MatGRUGate(nn.Module):
    """activation(W @ x + U @ hidden + bias) for [rows, cols] x and
    hidden."""

    def __init__(self, rows, cols, generator=None):
        super().__init__()
        self.W = _uniform((rows, rows), 1.0 / math.sqrt(rows), generator)
        self.U = _uniform((rows, rows), 1.0 / math.sqrt(rows), generator)
        self.bias = _uniform((rows, cols), 1.0 / math.sqrt(cols), generator)

    def forward(self, x, hidden, activation):
        return activation(self.W @ x + self.U @ hidden + self.bias)


class TopK(nn.Module):
    """The k nodes of highest score ``x @ scorer / |scorer|``, their rows
    scaled by tanh(score), as [feats, k].  No mask: every node competes,
    so the graph needs at least k nodes."""

    def __init__(self, feats, k, generator=None):
        super().__init__()
        self.scorer = _uniform((feats, 1), 1.0 / math.sqrt(feats), generator)
        self.k = k

    def forward(self, node_embs):
        if node_embs.shape[0] < self.k:
            raise ValueError(f"TopK needs at least k = {self.k} nodes, got "
                             f"{node_embs.shape[0]}")
        scores = (node_embs @ self.scorer) / torch.linalg.norm(self.scorer)
        vals, idx = torch.topk(scores[:, 0], self.k)
        return (node_embs[idx] * torch.tanh(vals)[:, None]).T


class MatGRUCell(nn.Module):
    """The GRU over the [input_dim, output_dim] weight: EGCNH drives it by
    the TopK summary of the step's node features, EGCNO by the weight."""

    def __init__(self, input_dim, output_dim, egcn_type="EGCNH",
                 generator=None):
        super().__init__()
        if egcn_type not in ("EGCNH", "EGCNO"):
            raise ValueError(f"egcn_type {egcn_type!r}")
        self.update = MatGRUGate(input_dim, output_dim, generator)
        self.reset = MatGRUGate(input_dim, output_dim, generator)
        self.htilda = MatGRUGate(input_dim, output_dim, generator)
        self.choose_topk = TopK(input_dim, output_dim, generator)
        self.egcn_type = egcn_type

    def forward(self, prev_Q, prev_Z=None):
        z_topk = (prev_Q if self.egcn_type == "EGCNO"
                  else self.choose_topk(prev_Z))
        update = self.update(z_topk, prev_Q, torch.sigmoid)
        reset = self.reset(z_topk, prev_Q, torch.sigmoid)
        h_cap = self.htilda(z_topk, reset * prev_Q, torch.tanh)
        return (1 - update) * prev_Q + update * h_cap


class GRCU(nn.Module):
    """One EvolveGCN layer: the weight evolves step by step from
    ``GCN_init_weights``, and step t computes rrelu(A_t @ (x_t @ W_t))."""

    def __init__(self, input_dim, output_dim, egcn_type="EGCNH",
                 generator=None):
        super().__init__()
        self.evolve_weights = MatGRUCell(input_dim, output_dim, egcn_type,
                                         generator)
        self.GCN_init_weights = _uniform(
            (input_dim, output_dim), 1.0 / math.sqrt(output_dim), generator)
        self.egcn_type = egcn_type

    def forward(self, adjs, xs, generator=None):
        """adjs: T ``SparseGraph``s; xs [T, N, in] -> [T, N, out]."""
        if len(adjs) != xs.shape[0]:
            raise ValueError(f"{len(adjs)} graphs for {xs.shape[0]} steps")
        W = self.GCN_init_weights
        outs = []
        for adj, x in zip(adjs, xs):
            W = (self.evolve_weights(W) if self.egcn_type == "EGCNO"
                 else self.evolve_weights(W, x))
            outs.append(_rrelu(spmm(adj, x @ W), generator))
        return torch.stack(outs)


class EvolveGCN(nn.Module):
    """Two ``GRCU`` layers (input -> hidden -> output)."""

    def __init__(self, input_dim, hidden_dim, output_dim, egcn_type="EGCNH",
                 generator=None):
        super().__init__()
        self.grcu1 = GRCU(input_dim, hidden_dim, egcn_type, generator)
        self.grcu2 = GRCU(hidden_dim, output_dim, egcn_type, generator)

    def forward(self, xs, adjs, generator=None):
        """xs [T, N, in] (the features; EvolveGCN has no identity fast
        path); adjs: T ``SparseGraph``s -> [T, N, out]."""
        return self.grcu2(adjs, self.grcu1(adjs, xs, generator), generator)
