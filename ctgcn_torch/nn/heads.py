# coding: utf-8
"""Prediction heads of the supervised learning types (port of
``ctgcn_tpu/nn/heads.py``): ``MLPClassifier``, the inner-product edge
scorer and ``EdgeClassifier``.

  * ``MLPClassifier`` holds one MLP: the reference builds ``duration`` of
    them but only ever applies the first, so the rest would be dead
    parameters.
  * ``inner_product`` scores an edge (i, j) by ``sum(z_i * z_j)``, or
    returns the product itself with ``reduce=False``.

Parameter names match the JAX trees (``mlp.layers.0.weight``,
``classifier.mlp.layers.0.weight``), so ``interop.params_from_numpy``
carries them across.
"""
from __future__ import annotations

import torch
from torch import nn

from ctgcn_torch.nn.layers import MLP


def _rows(x, idx):
    """``x[t][idx[t]]`` for every t of [T, N, d] and [T, B, ...] indices,
    or ``x[idx]`` for [N, d]."""
    if x.dim() == 3:
        t = torch.arange(x.shape[0], device=x.device)
        return x[t.view((-1,) + (1,) * (idx.dim() - 1)), idx]
    return x[idx]


class MLPClassifier(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, layer_num,
                 bias=True, activate_type="N", generator=None):
        super().__init__()
        self.mlp = MLP(input_dim, hidden_dim, output_dim, layer_num,
                       bias=bias, activate_type=activate_type,
                       generator=generator)

    def forward(self, x, batch_indices=None):
        """x: [N, d] or [T, N, d]; batch_indices: [B] or [T, B] rows."""
        if batch_indices is not None:
            x = _rows(x, batch_indices)
        return self.mlp(x)


def inner_product(x, edge_index, reduce=True):
    """Per-edge scores of x [N, d] (or [T, N, d]) for edge_index [2, E]
    (or [T, 2, E]): [E] (or [T, E]), the [.., E, d] products when
    ``reduce`` is false."""
    if x.dim() == 3:
        zi, zj = _rows(x, edge_index[:, 0]), _rows(x, edge_index[:, 1])
    else:
        zi, zj = x[edge_index[0]], x[edge_index[1]]
    prod = zi * zj
    return prod.sum(dim=-1) if reduce else prod


class EdgeClassifier(nn.Module):
    """``inner_product(reduce=False)``, then an ``MLPClassifier``."""

    def __init__(self, input_dim, hidden_dim, output_dim, layer_num,
                 bias=True, activate_type="N", generator=None):
        super().__init__()
        self.classifier = MLPClassifier(input_dim, hidden_dim, output_dim,
                                        layer_num, bias=bias,
                                        activate_type=activate_type,
                                        generator=generator)

    def forward(self, x, edge_index):
        return self.classifier(inner_product(x, edge_index, reduce=False))
