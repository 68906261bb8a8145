# coding: utf-8
"""VGRNN, the variational graph RNN (port of ``GraphConv``, ``GraphGRU``
and ``VGRNN`` in ``ctgcn_tpu/nn/vgrnn.py``).

A step encodes ``[phi_x(x_t), h]`` by three graph convolutions into the
posterior's mean and standard deviation, draws ``z_t = mean + eps * std``,
computes the prior from h, and updates h by a GRU whose six gates are graph
convolutions of ``[phi_x(x_t), phi_z(z_t)]`` and h.  The JAX
``lax.scan`` over time is a Python loop carrying h.  The convolutions read
the window's D^-1/2 (A_bin + 2I) D^-1/2, one ``SparseGraph`` a snapshot
(the driver builds it), through the zoo's ``spmm``: on graphs that carry
their plans that is the CUDA kernels, the backward on the transpose plan.

The inner-product decoder ``z_t z_t^T`` is not formed here: the VAE loss
(``losses.vae_loss``) takes z and never holds an [N, N] past its step.

Noise: ``eps`` is drawn from the ``generator`` passed in (the engine's), one
``_noise`` call a snapshot, or given as ``noise`` (T tensors [N, out]);
without either, from a generator seeded 0 made for the call, so every call
draws the same noise, as every call of the JAX model without a key draws
from ``jax.random.key(0)``.
Init: a GCN convolution's weight is glorot, U(+-sqrt(6 / (in + out))), its
bias zero; a SAGE or GIN convolution's weight and bias U(+-1/sqrt(in));
``Linear`` as in ``nn/layers.py``.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.nn.layers import Linear
from ctgcn_torch.ops.spmm import spmm

CONV_TYPES = ("GCN", "SAGE", "GIN")


def _uniform(shape, bound, generator):
    return nn.Parameter((torch.rand(*shape, generator=generator) * 2 - 1)
                        * bound)


def _noise(n, d, generator, like):
    """The posterior's noise of one snapshot: a standard normal [n, d]
    drawn from ``generator``, in ``like``'s dtype and on its device."""
    return torch.randn(n, d, generator=generator, device=like.device,
                       dtype=like.dtype)


class GraphConv(nn.Module):
    """GCN: act(spmm(A, x @ W) + b); SAGE: spmm(A, act(x @ W + b)) (A the
    row-normalized A + I: a mean over the node and its neighbours); GIN:
    act((spmm(A, x) + x) @ W + b)."""

    def __init__(self, input_dim, output_dim, conv_type="GCN", bias=False,
                 generator=None):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"conv_type {conv_type!r}, not one of "
                             f"{CONV_TYPES}")
        self.conv_type = conv_type
        if conv_type == "GCN":
            self.weight = _uniform(
                (input_dim, output_dim),
                math.sqrt(6.0 / (input_dim + output_dim)), generator)
            self.bias = (nn.Parameter(torch.zeros(output_dim)) if bias
                         else None)
        else:
            bound = 1.0 / math.sqrt(input_dim)
            self.weight = _uniform((input_dim, output_dim), bound, generator)
            self.bias = (_uniform((output_dim,), bound, generator) if bias
                         else None)

    def _add_bias(self, h):
        return h if self.bias is None else h + self.bias

    def forward(self, x, adj, act=None):
        if self.conv_type == "GCN":
            out = self._add_bias(spmm(adj, x @ self.weight))
        elif self.conv_type == "SAGE":
            h = self._add_bias(x @ self.weight)
            out = spmm(adj, h if act is None else act(h))
            act = None
        else:
            out = self._add_bias((spmm(adj, x) + x) @ self.weight)
        return out if act is None else act(out)


class GraphGRU(nn.Module):
    """A GRU whose six gates are ``GraphConv``s, ``n_layer`` deep."""

    def __init__(self, input_dim, hidden_dim, n_layer, conv_type="GCN",
                 bias=True, generator=None):
        super().__init__()

        def convs(first_dim):
            return nn.ModuleList(
                GraphConv(first_dim if i == 0 else hidden_dim, hidden_dim,
                          conv_type, bias, generator)
                for i in range(n_layer))

        self.xz, self.hz = convs(input_dim), convs(hidden_dim)
        self.xr, self.hr = convs(input_dim), convs(hidden_dim)
        self.xh, self.hh = convs(input_dim), convs(hidden_dim)

    def forward(self, inp, adj, h):
        """inp [N, in]; h [L, N, hid] -> the new h [L, N, hid]."""
        outs = []
        x = inp
        for i in range(len(self.xz)):
            z = torch.sigmoid(self.xz[i](x, adj) + self.hz[i](h[i], adj))
            r = torch.sigmoid(self.xr[i](x, adj) + self.hr[i](h[i], adj))
            h_tilde = torch.tanh(self.xh[i](x, adj)
                                 + self.hh[i](r * h[i], adj))
            x = z * h[i] + (1 - z) * h_tilde
            outs.append(x)
        return torch.stack(outs)


class VGRNN(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, rnn_layer_num=1,
                 conv_type="GCN", bias=True, generator=None):
        super().__init__()
        lin = dict(bias=bias, generator=generator)
        conv = dict(conv_type=conv_type, bias=bias, generator=generator)
        self.phi_x = Linear(input_dim, hidden_dim, **lin)
        self.phi_z = Linear(output_dim, hidden_dim, **lin)
        self.enc = GraphConv(2 * hidden_dim, hidden_dim, **conv)
        self.enc_mean = GraphConv(hidden_dim, output_dim, **conv)
        self.enc_std = GraphConv(hidden_dim, output_dim, **conv)
        self.prior = Linear(hidden_dim, hidden_dim, **lin)
        self.prior_mean = Linear(hidden_dim, output_dim, **lin)
        self.prior_std = Linear(hidden_dim, output_dim, **lin)
        self.rnn = GraphGRU(2 * hidden_dim, hidden_dim, rnn_layer_num,
                            **conv)
        self.hidden_dim = hidden_dim
        self.rnn_layer_num = rnn_layer_num

    def step(self, x, adj, h, eps):
        """One timestep: x [N, in] or None (identity features), adj the
        normalized ``SparseGraph``, h [L, N, hid], eps [N, out] ->
        (new h, (enc_mean, enc_std, prior_mean, prior_std, z))."""
        if x is None:
            # phi_x(I) is W + b: I is never formed
            w = self.phi_x.weight
            phi_x_t = F.relu(w if self.phi_x.bias is None
                             else w + self.phi_x.bias)
        else:
            phi_x_t = F.relu(self.phi_x(x))
        enc_t = self.enc(torch.cat([phi_x_t, h[-1]], dim=1), adj, act=F.relu)
        enc_mean_t = self.enc_mean(enc_t, adj)
        enc_std_t = self.enc_std(enc_t, adj, act=F.softplus)

        prior_t = F.relu(self.prior(h[-1]))
        prior_mean_t = self.prior_mean(prior_t)
        prior_std_t = F.softplus(self.prior_std(prior_t))

        z_t = enc_mean_t + eps * enc_std_t
        phi_z_t = F.relu(self.phi_z(z_t))
        h = self.rnn(torch.cat([phi_x_t, phi_z_t], dim=1), adj, h)
        return h, (enc_mean_t, enc_std_t, prior_mean_t, prior_std_t, z_t)

    def forward(self, xs, adjs, hx=None, generator=None, noise=None):
        """xs [T, N, in] or None (identity); adjs: T normalized
        ``SparseGraph``s; hx [L, N, hid] or None (zeros).  Returns
        (enc_mean [T, N, out], h [L, N, hid], (enc_mean, enc_std,
        prior_mean, prior_std, z), each [T, N, out])."""
        n = adjs[0].n_rows
        w = self.phi_x.weight
        if hx is None:
            hx = w.new_zeros(self.rnn_layer_num, n, self.hidden_dim)
        if noise is None and generator is None:
            generator = torch.Generator(device=w.device).manual_seed(0)
        h, outs = hx, []
        for t, adj in enumerate(adjs):
            eps = (noise[t] if noise is not None else _noise(
                n, self.enc_mean.weight.shape[1], generator, w))
            h, out_t = self.step(None if xs is None else xs[t], adj, h, eps)
            outs.append(out_t)
        stacked = tuple(torch.stack(o) for o in zip(*outs))
        return stacked[0], h, stacked
