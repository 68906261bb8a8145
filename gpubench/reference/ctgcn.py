"""CTGCN-C (Liu et al., "K-Core based Temporal Graph Convolutional Network
for Dynamic Graphs", TKDE 2020) in plain PyTorch.

Per snapshot t on identity features: x = W_t + b_t (a linear MLP of one
layer, so the identity input is a row lookup); then each CoreDiffusion
layer runs over the snapshot's k-core slots, max core first (the max-core
subgraph plus I, then each smaller core that differs from the last):
acc_k = acc_{k-1} + S_k x, h_k = GRU(relu(acc_k), h_{k-1}) from h_0 = 0,
and the layer's output is LayerNorm(sum_k h_k).  A GRU over the
snapshots' outputs and a LayerNorm give the embeddings [T, N, embed].
The backward recomputes one snapshot at a time (checkpoints), which
changes no value."""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch
from torch.utils.checkpoint import checkpoint

from reference import kcore
from reference.nn import (Sparse, gru, gru_flops, gru_params, gru_spec,
                          layer_norm, norm_spec, relu)

#: the random draws of the program's forward: none
DRAWS = ()


def _dims(cfg):
    if (cfg["model_type"], cfg["trans_layer_num"], cfg["rnn_type"],
            cfg["trans_activate_type"]) != ("C", 1, "GRU", "L"):
        raise ValueError("the reference covers CTGCN-C with one linear "
                         "transformation layer and GRUs")
    hid, out, L = cfg["hid_dim"], cfg["embed_dim"], cfg["diffusion_layer_num"]
    return [(hid, out)] + [(out, out)] * (L - 1)


def param_spec(cfg, n):
    spec = []
    bound = 1.0 / np.sqrt(n)
    for t in range(cfg["duration"]):
        spec += [(f"mlps.{t}.layers.0.weight", (n, cfg["hid_dim"]), "uniform",
                  bound),
                 (f"mlps.{t}.layers.0.bias", (cfg["hid_dim"],), "uniform",
                  bound)]
        for li, (d_in, d_out) in enumerate(_dims(cfg)):
            spec += gru_spec(f"cdns.{t}.layers.{li}.rnn", d_in, d_out)
            spec += norm_spec(f"cdns.{t}.layers.{li}.norm", d_out)
    out = cfg["embed_dim"]
    return spec + gru_spec("rnn", out, out) + norm_spec("norm", out)


class Prepared:
    """The reference's own window: each snapshot's slots on the device."""

    def __init__(self, adjs, device):
        self.n = adjs[0].shape[0]
        self.adjs = adjs
        self.slots = [[Sparse(m, device) for m in kcore.pyramid_slots(a)]
                      for a in adjs]


def prepare(adjs, cfg, device):
    return Prepared(adjs, device)


def _layer(x, slots, p_rnn, scale, offset):
    acc = None
    h = x.new_zeros(x.shape[0], p_rnn[1].shape[1])
    total = torch.zeros_like(h)
    for s in slots:
        c = s @ x
        acc = c if acc is None else acc + c
        h = gru(relu(acc), h, p_rnn)
        total = total + h
    return layer_norm(total, scale, offset)


def forward(params, prep, cfg):
    """Embeddings [T, N, embed]."""
    layers = len(_dims(cfg))

    def snapshot(t, *leaves):
        w, b, rest = leaves[0], leaves[1], leaves[2:]
        x = w + b
        for li in range(layers):
            p = rest[6 * li:6 * li + 6]
            x = _layer(x, prep.slots[t], p[:4], p[4], p[5])
        return x

    outs = []
    for t in range(cfg["duration"]):
        leaves = [params[f"mlps.{t}.layers.0.weight"],
                  params[f"mlps.{t}.layers.0.bias"]]
        for li in range(layers):
            pre = f"cdns.{t}.layers.{li}"
            leaves += list(gru_params(params, pre + ".rnn"))
            leaves += [params[pre + ".norm.scale"],
                       params[pre + ".norm.offset"]]
        if torch.is_grad_enabled():
            outs.append(checkpoint(snapshot, t, *leaves, use_reentrant=False))
        else:
            outs.append(snapshot(t, *leaves))
    p_time = gru_params(params, "rnn")
    h = torch.zeros_like(outs[0])
    seq = []
    for x in outs:
        h = gru(x, h, p_time)
        seq.append(h)
    return layer_norm(torch.stack(seq), params["norm.scale"],
                      params["norm.offset"])


def flops(prep, cfg):
    """(forward, backward) FLOPs of one forward of the window: the slot
    SpMMs (2 nnz d) and the GRU GEMMs; the identity input is a lookup.
    The backward takes dx of each SpMM (once its forward) and dx and dW of
    each GEMM (twice its forward)."""
    fwd = bwd = 0.0
    n, out = prep.n, cfg["embed_dim"]
    for slots in prep.slots:
        for d_in, hid in _dims(cfg):
            sp_f = sum(2.0 * s.nnz * d_in for s in slots)
            g_f = len(slots) * gru_flops(n, d_in, hid)
            fwd += sp_f + g_f
            bwd += sp_f + 2 * g_f
    t_f = len(prep.slots) * gru_flops(n, out, out)
    return fwd + t_f, bwd + 2 * t_f


def setup_checks(prep, args, captured):
    """{"core_mismatch": the (snapshot, k) k-core files the program's
    preprocessing wrote that differ from the reference's k-core subgraph,
    or that are missing or extra}."""
    del captured
    root = os.path.join(args["base_path"], args["core_folder"])
    bad = 0
    for date, adj in zip(sorted(os.listdir(root)), prep.adjs):
        files = sorted(os.listdir(os.path.join(root, date)))
        want = kcore.kcore_matrices(adj)
        bad += abs(len(files) - len(want))
        for f, (k, mat) in zip(files, want):
            got = sp.load_npz(os.path.join(root, date, f)).tocsr()
            if int(os.path.splitext(f)[0]) != k or got.shape != mat.shape \
                    or (abs(got - mat) > 0).nnz:
                bad += 1
    return {"core_mismatch": bad}
