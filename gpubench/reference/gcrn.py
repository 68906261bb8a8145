"""GCRN (Seo et al., "Structured Sequence Modeling with Graph
Convolutional Recurrent Networks", arXiv:1612.07659) as the CTGCN authors'
code runs it, in plain PyTorch.

Per snapshot t on identity features, with Â_t = D^-1 (A_t + I):
h = dropout(relu(Â_t W1_t + b1_t)), y = Â_t (h W2_t) + b2_t, each row of
y divided by max(its L2 norm, 1e-12); then a GRU over the snapshots and a
LayerNorm give the embeddings [T, N, embed].  The dropout masks are the
program's own draws, given in ``masks`` (one keep mask, bool [N, hid],
a snapshot):
inverted dropout keeps an entry with probability 1 - p and scales it by
1 / (1 - p)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch.nn import functional as F

from reference.graph import row_normalised
from reference.nn import (Sparse, gru, gru_flops, gru_params, gru_spec,
                          layer_norm, mm, norm_spec, relu)

#: the random draws of the program's forward: its dropout masks
DRAWS = ("dropout",)


def param_spec(cfg, n):
    if cfg["rnn_type"] != "GRU":
        raise ValueError("the reference covers GCRN with a GRU")
    hid, out = cfg["hid_dim"], cfg["embed_dim"]
    spec = []
    # a graph convolution draws U(-1/sqrt(out), 1/sqrt(out))
    b1, b2 = 1 / np.sqrt(hid), 1 / np.sqrt(out)
    for t in range(cfg["duration"]):
        spec += [(f"gcns.{t}.gc1.weight", (n, hid), "uniform", b1),
                 (f"gcns.{t}.gc1.bias", (hid,), "uniform", b1),
                 (f"gcns.{t}.gc2.weight", (hid, out), "uniform", b2),
                 (f"gcns.{t}.gc2.bias", (out,), "uniform", b2)]
    return spec + gru_spec("rnn", out, out) + norm_spec("norm", out)


class Prepared:
    def __init__(self, adjs, device):
        self.n = adjs[0].shape[0]
        self.adjs = adjs
        self.norm = [row_normalised(a) for a in adjs]
        self.mats = [Sparse(m, device) for m in self.norm]


def prepare(adjs, cfg, device):
    return Prepared(adjs, device)


def forward(params, prep, cfg, masks=None):
    p = cfg["dropout"]
    outs = []
    for t, a in enumerate(prep.mats):
        h = relu(a @ params[f"gcns.{t}.gc1.weight"]
                 + params[f"gcns.{t}.gc1.bias"])
        if masks is not None:
            h = torch.where(masks[t], h / (1 - p), torch.zeros_like(h))
        y = a @ mm(h, params[f"gcns.{t}.gc2.weight"]) \
            + params[f"gcns.{t}.gc2.bias"]
        outs.append(F.normalize(y, dim=1, eps=1e-12))
    h = torch.zeros_like(outs[0])
    seq = []
    for x in outs:
        h = gru(x, h, gru_params(params, "rnn"))
        seq.append(h)
    return layer_norm(torch.stack(seq), params["norm.scale"],
                      params["norm.offset"])


def flops(prep, cfg):
    """(forward, backward) FLOPs of one forward of the window: two SpMMs
    and one GEMM a snapshot and the GRU; the identity input is a lookup.
    The backward takes d(W1) through the first SpMM (once its forward),
    dx of the second, and dx and dW of each GEMM."""
    hid, out, n = cfg["hid_dim"], cfg["embed_dim"], prep.n
    fwd = bwd = 0.0
    for a in prep.mats:
        s1, s2 = 2.0 * a.nnz * hid, 2.0 * a.nnz * out
        g = 2.0 * n * hid * out + gru_flops(n, out, out)
        fwd += s1 + s2 + g
        bwd += s1 + s2 + 2 * g
    return fwd, bwd


def setup_checks(prep, args, captured):
    """{"adj_mismatch": entries of the program's D^-1 (A + I) graphs
    (captured as (rows, cols, vals) a snapshot) that differ from the
    reference's in float32, or that one side lacks}."""
    del args
    bad = 0
    for (rows, cols, vals), ref in zip(captured["adjs"], prep.norm):
        got = sp.coo_matrix(
            (vals.astype(np.float64), (rows, cols)), shape=ref.shape).tocsr()
        want = ref.astype(np.float32).astype(np.float64).tocsr()
        bad += int((got != want).nnz)
    return {"adj_mismatch": bad}
