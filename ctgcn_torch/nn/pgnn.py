# coding: utf-8
"""P-GNN, the position-aware GNN (port of ``ctgcn_tpu/nn/pgnn.py``).

  * ``precompute_dist_data``: the window's proximity matrices
    1/(d + 1) of the unweighted shortest-path distance d, 0 where a node is
    unreachable (or farther than ``approximate`` hops when it is > 0), in
    float64 before the cast to float32, as the JAX function computes them.
    scipy's ``dijkstra`` runs over row chunks into one float32 [N, N]
    buffer, which goes to the device before the next snapshot, so the host
    never holds a float64 [N, N].
  * ``anchor_sizes``: m = floor(log2 N) size tiers of m sets each,
    ``int(N / 2^(i + 1))`` nodes a set in tier i.
  * ``draw_anchor_sets`` and ``anchor_reduce`` split the JAX
    ``select_anchor_dists``: a set's anchors are the top-k of uniform draws
    (sampling without replacement, in descending order of the draws, as
    ``lax.top_k`` gives them); a node's message from the set comes from its
    closest anchor, the first in that order among equals.  The proximity
    matrix is symmetric, so the reduction reads each anchor's row (its
    column) and takes the maximum over the set, in chunks of at most
    ``REDUCE_CHUNK_ELEMS`` gathered elements.
  * ``PGNNLayer`` takes each node's message from its closest anchor of
    every set, scaled by an MLP of the proximity, concatenates the node's
    own feature, and applies Linear + ReLU; its position output is one
    scalar a set, its structure output the mean over the sets.  ``PGNN``
    stacks a first, hidden and last layer; its output is the last layer's
    position output, L2-normalized (the first layer's, unnormalized, when
    ``layer_num`` is 1): one column per anchor set, whatever
    ``output_dim`` is.

Init: every weight xavier-uniform at ReLU's gain (U(+-sqrt(2) sqrt(6 /
(in + out)))), every bias zero.  Dropout draws its masks from the
``generator`` passed in, after the first and after each hidden layer, and
is off without one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.nn.gcn import _dropout, per_snapshot, skip_dropout
from ctgcn_torch.nn.layers import Linear

#: float64 elements of one ``dijkstra`` row chunk (256 MiB)
DIST_CHUNK_ELEMS = 1 << 25
#: proximities gathered at a time by ``anchor_reduce`` (1 GiB in f32)
REDUCE_CHUNK_ELEMS = 1 << 28


def _proximity_rows(adj, rows, limit):
    """1/(d + 1) for the rows ``rows`` of the distance matrix, 0 where
    unreachable, float64 (the JAX function's arithmetic)."""
    from scipy.sparse.csgraph import dijkstra

    d = dijkstra(adj, directed=False, unweighted=True, limit=limit,
                 indices=rows)
    return np.where(np.isfinite(d), 1.0 / (d + 1.0), 0.0)


def _check_symmetric(prox, tile=512):
    """Raise unless ``prox`` equals its transpose, checked by square tiles
    of its upper triangle (a tile's transpose stays in cache)."""
    n = prox.shape[0]
    for i in range(0, n, tile):
        for j in range(i, n, tile):
            if not np.array_equal(prox[i:i + tile, j:j + tile],
                                  prox[j:j + tile, i:i + tile].T):
                raise AssertionError("the proximity matrix is not "
                                     "symmetric")


def precompute_dist_data(edge_list, node_num, approximate=-1, device=None):
    """[T, N, N] float32 proximity matrices on ``device`` (the CPU by
    default), bit-equal to the JAX ``precompute_dist_data``.

    edge_list: one int [2, E] array a snapshot (both directions present)."""
    import scipy.sparse as sp

    limit = (float(approximate) if approximate and approximate > 0
             else np.inf)
    n = node_num
    out = torch.empty((len(edge_list), n, n), dtype=torch.float32,
                      device=device)
    buf = np.empty((n, n), np.float32)
    step = max(1, DIST_CHUNK_ELEMS // max(n, 1))
    for t, ei in enumerate(edge_list):
        ei = np.asarray(ei)
        adj = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                            shape=(n, n)).tocsr()
        for a in range(0, n, step):
            buf[a:a + step] = _proximity_rows(
                adj, np.arange(a, min(a + step, n)), limit)
        _check_symmetric(buf)
        out[t].copy_(torch.from_numpy(buf))
    return out


def anchor_sizes(n, c=1.0):
    """The anchor-set sizes: ``int(c * m)`` sets of ``int(n / 2^(i + 1))``
    nodes for each tier i < m = floor(log2 n)."""
    m = int(np.log2(n))
    copy = int(c * m)
    sizes = []
    for i in range(m):
        sizes.extend([int(n / np.exp2(i + 1))] * copy)
    return sizes


def _tiers(sizes):
    """Runs of equal consecutive sizes: [(size, count), ...]."""
    runs = []
    for s in sizes:
        if runs and runs[-1][0] == s:
            runs[-1][1] += 1
        else:
            runs.append([s, 1])
    return runs


def draw_anchor_sets(n, sizes, generator, device=None):
    """One int64 tensor of ``max(s, 1)`` distinct node ids per size of
    ``sizes``: the top-k of uniform draws from ``generator``, in descending
    order of the draws."""
    sets = []
    for s, count in _tiers(sizes):
        draws = torch.rand(count, n, generator=generator, device=device)
        sets.extend(draws.topk(max(s, 1), dim=1).indices.unbind(0))
    return sets


def anchor_reduce(dists, anchor_sets, chunk_elems=REDUCE_CHUNK_ELEMS):
    """(dists_max [N, A], dists_argmax int64 [N, A]) of the symmetric
    [N, N] ``dists``: for each node and anchor set, the largest proximity
    to the set's anchors and the first anchor (in the set's order) that
    holds it; a node that reaches no anchor gets 0 and the set's first
    anchor."""
    n = dists.shape[1]
    maxs, args = [], []
    start = 0
    for s, count in _tiers([len(a) for a in anchor_sets]):
        idx = torch.stack(anchor_sets[start:start + count])      # [c, s]
        start += count
        step = max(1, chunk_elems // (count * n))
        best = arg = None
        for j in range(0, s, step):
            part = idx[:, j:j + step]
            sub = dists.index_select(0, part.reshape(-1)).view(
                count, part.shape[1], n)
            val, pos = sub.max(dim=1)              # the first maximum
            who = part.gather(1, pos)
            if best is None:
                best, arg = val, who
            else:
                later = val > best                 # ties keep the earlier
                best = torch.where(later, val, best)
                arg = torch.where(later, who, arg)
        maxs.append(best)
        args.append(arg)
    return torch.cat(maxs).T.contiguous(), torch.cat(args).T.contiguous()


def select_anchor_dists(dists, sizes, generator=None, anchor_sets=None):
    """Anchor sets drawn from ``generator`` (or given as ``anchor_sets``),
    then ``anchor_reduce``."""
    if anchor_sets is None:
        anchor_sets = draw_anchor_sets(dists.shape[1], sizes, generator,
                                       dists.device)
    return anchor_reduce(dists, [a.to(dists.device) for a in anchor_sets])


def _lin(input_dim, output_dim, bias, generator):
    """A ``Linear`` with PGNN's init: xavier-uniform weight at ReLU's gain,
    zero bias."""
    lin = Linear(input_dim, output_dim, bias=bias, generator=generator)
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (input_dim + output_dim))
    with torch.no_grad():
        lin.weight.copy_((torch.rand(input_dim, output_dim,
                                     generator=generator) * 2 - 1) * bound)
        if lin.bias is not None:
            lin.bias.zero_()
    return lin


class Nonlinear(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, bias=True,
                 generator=None):
        super().__init__()
        self.linear1 = _lin(input_dim, hidden_dim, bias, generator)
        self.linear2 = _lin(hidden_dim, output_dim, bias, generator)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class PGNNLayer(nn.Module):
    def __init__(self, input_dim, output_dim, bias=True, generator=None):
        super().__init__()
        self.dist_compute = Nonlinear(1, output_dim, 1, bias, generator)
        self.linear_hidden = _lin(input_dim * 2, output_dim, bias, generator)
        self.linear_out_position = _lin(output_dim, 1, bias, generator)

    def forward(self, feature, dists_max, dists_argmax):
        """feature [N, d]; dists_max, dists_argmax [N, A] -> (position
        [N, A], structure [N, out])."""
        dm = self.dist_compute(dists_max[..., None])[..., 0]
        subset = feature[dists_argmax]                        # [N, A, d]
        messages = torch.cat([subset * dm[..., None],
                              feature[:, None, :].expand_as(subset)], dim=-1)
        messages = F.relu(self.linear_hidden(messages))       # [N, A, out]
        return (self.linear_out_position(messages)[..., 0],
                messages.mean(dim=1))


class PGNN(nn.Module):
    def __init__(self, input_dim, feature_dim, hidden_dim, output_dim,
                 feature_pre=True, layer_num=2, dropout=0.5, bias=True,
                 generator=None):
        super().__init__()
        if layer_num == 1:
            hidden_dim = output_dim
        self.linear_pre = (_lin(input_dim, feature_dim, bias, generator)
                           if feature_pre else None)
        self.conv_first = PGNNLayer(feature_dim if feature_pre else input_dim,
                                    hidden_dim, bias, generator)
        self.conv_hidden = nn.ModuleList(
            PGNNLayer(hidden_dim, hidden_dim, bias, generator)
            for _ in range(max(layer_num - 2, 0)))
        self.conv_out = (PGNNLayer(hidden_dim, output_dim, bias, generator)
                         if layer_num > 1 else None)
        self.layer_num = layer_num
        self.dropout = dropout

    def single(self, x, dists_max, dists_argmax, generator=None):
        """One snapshot: x [N, in] or None (identity features, with
        ``feature_pre``) -> [N, A]."""
        if self.linear_pre is not None:
            pre = self.linear_pre
            if x is None:
                x = pre.weight if pre.bias is None else pre.weight + pre.bias
            else:
                x = pre(x)
        x_position, x = self.conv_first(x, dists_max, dists_argmax)
        if self.layer_num == 1:
            return x_position
        x = _dropout(x, self.dropout, generator)
        for conv in self.conv_hidden:
            _, x = conv(x, dists_max, dists_argmax)
            x = _dropout(x, self.dropout, generator)
        x_position, _ = self.conv_out(x, dists_max, dists_argmax)
        return x_position / torch.clamp(
            torch.linalg.vector_norm(x_position, dim=-1, keepdim=True),
            min=1e-12)

    def skip_draws(self, n, generator, device):
        """Draw the dropout masks ``single`` draws for a snapshot of n
        nodes (the anchors are the caller's)."""
        if self.layer_num == 1:
            return
        width = self.conv_first.linear_hidden.weight.shape[1]
        for _ in range(1 + len(self.conv_hidden)):
            skip_dropout((n, width), self.dropout, generator, device)

    def forward(self, xs, dists_max, dists_argmax, generator=None, own=None,
                time_length=None):
        """xs [T, N, in] or None; dists_max, dists_argmax [T, N, A] ->
        [T, N, A] (the ``own`` snapshots of ``time_length``:
        ``per_snapshot``)."""
        return per_snapshot(
            lambda i: self.single(None if xs is None else xs[i],
                                  dists_max[i], dists_argmax[i], generator),
            lambda t: self.skip_draws(dists_max.shape[1], generator,
                                      dists_max.device),
            time_length or dists_max.shape[0], own)
