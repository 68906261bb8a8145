# coding: utf-8
"""Dense layers: Linear, MLP, LayerNorm (port of ``ctgcn_tpu/nn/layers.py``).

  * ``Linear.weight`` is [in, out] (``x @ W + b``), the JAX package's
    layout, so parameters carry across unchanged; init is
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.
  * MLP 'N' mode applies SELU after EVERY layer including the last; 'L'
    mode is linear.
  * LayerNorm: eps inside the sqrt, biased variance.

``TimeRule`` is what a model declares of how it splits over time parts
(its ``time_rule`` class attribute, read by ``parallel.mesh``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class TimeRule:
    """How a model splits over time parts: ``stacked``, its top-level
    containers with one module a timestep (a part keeps its slice);
    ``after_gather``, its top-level children used only after the gather
    over T (their gradients averaged).  Every other parameter is shared by
    the snapshots and used before the gather (summed)."""

    stacked: tuple = ()
    after_gather: tuple = ()


class Linear(nn.Module):
    def __init__(self, input_dim, output_dim, bias=True, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(input_dim)

        def uniform(*shape):
            return nn.Parameter(
                (torch.rand(*shape, generator=generator) * 2 - 1) * bound)

        self.weight = uniform(input_dim, output_dim)
        self.bias = uniform(output_dim) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class MLP(nn.Module):
    """k-layer perceptron; activate_type 'L' (linear) or 'N' (SELU after
    every layer, including the last)."""

    def __init__(self, input_dim, hidden_dim, output_dim, layer_num,
                 bias=True, activate_type="N", generator=None):
        super().__init__()
        if activate_type not in ("L", "N") or layer_num < 1:
            raise ValueError(f"MLP({activate_type!r}, {layer_num} layers)")
        dims = ([input_dim, output_dim] if layer_num == 1 else
                [input_dim] + [hidden_dim] * (layer_num - 1) + [output_dim])
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], bias, generator=generator)
            for i in range(layer_num))
        self.activate_type = activate_type

    def forward(self, x):
        """``x=None`` means identity features (x = I_N): the first layer
        returns its weight (plus bias) without materializing I."""
        first = self.layers[0]
        if x is None:
            h = first.weight if first.bias is None else first.weight + first.bias
        else:
            h = first(x)
        for lin in self.layers[1:]:
            if self.activate_type == "N":
                h = F.selu(h)
            h = lin(h)
        return F.selu(h) if self.activate_type == "N" else h


class LayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.offset = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.scale, self.offset, self.eps)


def layer_norm(x, scale, offset, eps):
    """LayerNorm over the last axis (eps inside the sqrt, biased
    variance); ``scale`` and ``offset`` [H], or [T, 1, H] for T norms
    stacked over x [T, N, H]."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + offset
