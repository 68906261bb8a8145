"""VGRNN (Hajiramezanali et al., "Variational Graph Recurrent Neural
Networks", NeurIPS 2019, arXiv:1908.09710) as the CTGCN authors run it
(``jhljx/CTGCN`` ``config/enron.json``, VGRNN: U-own, hid 500, embed 128,
one GRU layer, GCN convolutions with bias, eps 1e-10), in plain PyTorch.

Per snapshot t on identity features, with Â_t = D^-1/2 (A_bin + 2I)
D^-1/2 over the binary structure of A_t (the improved GCN normalisation,
self-loops of weight 2) and h the hidden state [N, hid], zeros at the
window's start unless given:

  phi_x = relu(W_x + b_x)                         (phi_x(I), I never formed)
  enc = relu(Â [phi_x, h] W_e + b_e)
  mean = Â enc W_m + b_m,  std = softplus(Â enc W_s + b_s)
  prior = relu(h W_p + b_p),  p_mean = prior W_pm + b_pm,
  p_std = softplus(prior W_ps + b_ps)
  z = mean + eps_t * std                          (eps_t: the program's draw)
  x = [phi_x, relu(z W_z + b_z)]
  u = sigmoid(G_xz(x) + G_hz(h)),  r = sigmoid(G_xr(x) + G_hr(h))
  h = u * h + (1 - u) * tanh(G_xh(x) + G_hh(r * h)),  G(v) = Â v W + b.

The loss of a snapshot is the KL divergence of the posterior from the
prior, 0.5 / N times the mean over nodes of the sum over dimensions of
2 log(p_std + eps) - 2 log(std + eps) + ((std + eps)^2 + (mean - p_mean)^2)
/ (p_std + eps)^2 - 1, plus ``norm`` times the mean over all N^2 pairs of
the binary cross-entropy with logits of z z^T against A_t with the
positive weight ``posw``; posw = (N^2 - s) / s and norm = N^2 / (2 (N^2 -
s)), s the sum of A_t's weights.  The window's loss is the sum over its
snapshots.

Departures from the paper, each the CTGCN authors' code's:
  * the target is the raw weighted adjacency (posw and norm from its sum
    of weights, not an edge count), the convolutions' graph its binary
    structure;
  * one GRU layer whatever ``rnn_layer_num`` says;
  * under U-own the loss ignores the node batch: every batch adds the
    whole window's loss, and h crosses an epoch's batches detached, zeros
    at each epoch's start (``jobs/uown.py`` follows that protocol);
  * eps inside every log and square of the KL term.

The dense term is formed in row chunks of ``CHUNK_ELEMS`` pairs so that it
fits on the card at N = 87,036: each chunk forms its rows of z z^T and of
the dense target and calls ``binary_cross_entropy_with_logits`` under
``torch.utils.checkpoint``, so plain autograd recomputes the chunk in the
backward and nothing of N^2 size outlives it.  Float32 throughout, every
GEMM through ``reference.nn.mm`` (TF32 off; the control turns it on).
The graphs are rebuilt from the raw snapshots in float64, then float32.
``gram_gaps`` holds the program's dense softplus sum, call by call, to
``softplus_gram`` (the same chunks under plain autograd) at the z the
program was given: the steps' norms average the rounding of the Gram's
GEMMs away, its dz elementwise does not.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from reference.nn import Sparse, mm, relu

#: the random draws of the program's forward: the posterior's noise
DRAWS = ("noise",)
#: pairs of z z^T formed at a time by the dense term (0.5 GiB in float32)
CHUNK_ELEMS = 1 << 27
GATES = ("xz", "hz", "xr", "hr", "xh", "hh")


def _linear(name, d_in, d_out):
    b = 1 / np.sqrt(d_in)
    return [(f"{name}.weight", (d_in, d_out), "uniform", b),
            (f"{name}.bias", (d_out,), "uniform", b)]


def _conv(name, d_in, d_out):
    """A GCN convolution: glorot weight, zero bias."""
    return [(f"{name}.weight", (d_in, d_out), "uniform",
             np.sqrt(6.0 / (d_in + d_out))),
            (f"{name}.bias", (d_out,), "zeros", None)]


def param_spec(cfg, n):
    """The leaves, named as the port's ``VGRNN.named_parameters()``."""
    if cfg["conv_type"] != "GCN" or not cfg["bias"]:
        raise ValueError("the reference covers VGRNN with biased GCN "
                         "convolutions")
    hid, out = cfg["hid_dim"], cfg["embed_dim"]
    spec = (_linear("phi_x", n, hid) + _linear("phi_z", out, hid)
            + _conv("enc", 2 * hid, hid) + _conv("enc_mean", hid, out)
            + _conv("enc_std", hid, out) + _linear("prior", hid, hid)
            + _linear("prior_mean", hid, out) + _linear("prior_std", hid, out))
    for g in GATES:
        spec += _conv(f"rnn.{g}.0", 2 * hid if g[0] == "x" else hid, hid)
    return spec


def conv_graph(adj):
    """D^-1/2 (A_bin + 2I) D^-1/2 of ``adj``'s binary structure, float64
    CSR."""
    b = (adj.tocsr() != 0).astype(np.float64)
    m = (b + 2.0 * sp.eye(b.shape[0], format="csr")).tocsr()
    dinv = sp.diags(np.asarray(m.sum(axis=1)).ravel() ** -0.5)
    return (dinv @ m @ dinv).tocsr()


class Prepared:
    def __init__(self, adjs, device):
        self.n = adjs[0].shape[0]
        self.adjs = adjs
        self.norm = [conv_graph(a) for a in adjs]
        self.mats = [Sparse(m, device) for m in self.norm]
        self.targets = [Sparse(a.tocsr(), device) for a in adjs]
        self.indptr = [a.tocsr().indptr.astype(np.int64) for a in adjs]
        tot = float(self.n) ** 2
        weights = [float(a.sum()) for a in adjs]
        self.posw = [torch.tensor((tot - s) / s, dtype=torch.float32,
                                  device=device) for s in weights]
        self.bce_scale = [float(np.float32(tot / (2.0 * (tot - s)) / tot))
                          for s in weights]


def prepare(adjs, cfg, device):
    return Prepared(adjs, device)


def _gcn(params, name, a, x):
    return a @ mm(x, params[name + ".weight"]) + params[name + ".bias"]


def _lin(params, name, x):
    return mm(x, params[name + ".weight"]) + params[name + ".bias"]


def run(params, prep, cfg, noise, h=None):
    """The window from the hidden state ``h`` (zeros when None) with the
    noise ``noise`` (one [N, embed] tensor a snapshot): ([(mean, std,
    p_mean, p_std, z)] a snapshot, the last h)."""
    hid = cfg["hid_dim"]
    phi_x = relu(params["phi_x.weight"] + params["phi_x.bias"])
    if h is None:
        h = phi_x.new_zeros(prep.n, hid)
    outs = []
    for t, a in enumerate(prep.mats):
        enc = relu(_gcn(params, "enc", a, torch.cat([phi_x, h], 1)))
        mean = _gcn(params, "enc_mean", a, enc)
        std = F.softplus(_gcn(params, "enc_std", a, enc))
        prior = relu(_lin(params, "prior", h))
        p_mean = _lin(params, "prior_mean", prior)
        p_std = F.softplus(_lin(params, "prior_std", prior))
        z = mean + noise[t] * std
        x = torch.cat([phi_x, relu(_lin(params, "phi_z", z))], 1)

        def gate(g, v):
            return _gcn(params, f"rnn.{g}.0", a, v)
        u = torch.sigmoid(gate("xz", x) + gate("hz", h))
        r = torch.sigmoid(gate("xr", x) + gate("hr", h))
        h = u * h + (1 - u) * torch.tanh(gate("xh", x) + gate("hh", r * h))
        outs.append((mean, std, p_mean, p_std, z))
    return outs, h


def forward(params, prep, cfg, noise=None):
    """The embeddings, the posterior means [T, N, embed], from zeros."""
    return torch.stack([o[0] for o in run(params, prep, cfg, noise)[0]])


def _bce_rows(z_rows, z, rows, cols, vals, posw):
    """sum over a row chunk of the binary cross-entropy with logits of
    z_rows z^T against the target's rows there (``rows`` counted from the
    chunk's first)."""
    x = mm(z_rows, z.t())
    y = torch.zeros_like(x)
    y[rows, cols] = vals
    return F.binary_cross_entropy_with_logits(x, y, pos_weight=posw,
                                              reduction="sum")


def dense_bce(z, target, indptr, posw):
    """The sum over all N^2 pairs of the weighted binary cross-entropy of
    z z^T against ``target``, in row chunks, each recomputed in the
    backward."""
    n = z.shape[0]
    step = max(1, CHUNK_ELEMS // n)
    total = z.new_zeros(())
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        a, b = int(indptr[r0]), int(indptr[r1])
        total = total + checkpoint(
            _bce_rows, z[r0:r1], z, target.rows[a:b] - r0, target.cols[a:b],
            target.vals[a:b], posw, use_reentrant=False,
            preserve_rng_state=False)
    return total


def _softplus_rows(z_rows, z):
    return F.softplus(mm(z_rows, z.t())).sum()


def softplus_gram(z):
    """The sum over all N^2 pairs of softplus(z z^T), the dense sum of the
    program's VAE loss without its target, in row chunks, each recomputed
    in the backward."""
    n = z.shape[0]
    step = max(1, CHUNK_ELEMS // n)
    total = z.new_zeros(())
    for r0 in range(0, n, step):
        total = total + checkpoint(_softplus_rows, z[r0:r0 + step], z,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def gram_gaps(calls, device):
    """For each recorded call of the program's dense softplus sum (its z,
    its sum, the gradient g it was given and the dz it returned), the
    reference's at the same z by plain autograd: (|sum - ref| / |ref|,
    max |dz - ref| / max |ref|)."""
    out = []
    for c in calls:
        z = c["z"].to(device).requires_grad_()
        total = softplus_gram(z)
        (dz,) = torch.autograd.grad(total, z, torch.tensor(
            c["g"], dtype=z.dtype, device=device))
        ref = float(total.detach())
        out.append((abs(c["sum"] - ref) / abs(ref),
                    float((c["dz"].to(device) - dz).abs().max()
                          / dz.abs().max())))
        del z, total, dz
    return out


def vae_loss(outs, prep, cfg):
    """The window's VAE loss from ``run``'s outputs."""
    eps, n = cfg["eps"], prep.n
    total = 0.0
    for t, (mean, std, p_mean, p_std, z) in enumerate(outs):
        kld_el = (2 * torch.log(p_std + eps) - 2 * torch.log(std + eps)
                  + ((std + eps) ** 2 + (mean - p_mean) ** 2)
                  / (p_std + eps) ** 2 - 1)
        kld = (0.5 / n) * kld_el.sum(1).mean()
        total = total + kld + prep.bce_scale[t] * dense_bce(
            z, prep.targets[t], prep.indptr[t], prep.posw[t])
    return total


def gram_flops(n, d):
    """(forward, backward) FLOPs of one snapshot's dense term, as the
    program forms it: z z^T once forward, and again with its product with
    z backward."""
    return 2.0 * n * n * d, 4.0 * n * n * d


def flops(prep, cfg):
    """(forward, backward) FLOPs of one forward of the window and its
    loss: per snapshot the GEMMs and SpMMs of the encoder, the prior,
    phi_z and the GRU's six gates, the dense term (``gram_flops``) and the
    target's inner products.  The backward takes dx and dW of each GEMM
    and the transpose of each SpMM; the last snapshot's gates get none (its
    h reaches no loss), and the identity input is a lookup."""
    hid, out, n = cfg["hid_dim"], cfg["embed_dim"], prep.n
    fwd = bwd = 0.0
    for t, (a, tgt) in enumerate(zip(prep.mats, prep.targets)):
        def conv(d_in, d_out):
            return 2.0 * n * d_in * d_out, 2.0 * a.nnz * d_out
        enc = [conv(2 * hid, hid), conv(hid, out), conv(hid, out)]
        gates = [conv(2 * hid if g[0] == "x" else hid, hid) for g in GATES]
        lin = 2.0 * n * (hid * hid + 2 * hid * out + out * hid)
        gf, gb = gram_flops(n, out)
        sddmm = 2.0 * tgt.nnz * out
        g_fwd = sum(m + s for m, s in gates)
        fwd += sum(m + s for m, s in enc) + lin + g_fwd + gf + sddmm
        bwd += (sum(2 * m + s for m, s in enc) + 2 * lin + gb + 2 * sddmm
                + (0.0 if t == len(prep.mats) - 1
                   else sum(2 * m + s for m, s in gates)))
    return fwd, bwd


def _mismatch(captured, want):
    """Entries of ``captured`` (rows, cols, vals) that differ from the
    float64 matrix ``want`` in float32, or that one side lacks."""
    rows, cols, vals = captured
    got = sp.coo_matrix((vals.astype(np.float64), (rows, cols)),
                        shape=want.shape).tocsr()
    return int((got != want.astype(np.float32).astype(np.float64)
                .tocsr()).nnz)


def setup_checks(prep, args, captured):
    """{"target_mismatch": entries of the program's VAE target (its
    ``data["adjs"]``, captured as (rows, cols, vals) a snapshot) that
    differ from the raw A in float32, or that one side lacks}."""
    del args
    return {"target_mismatch": sum(
        _mismatch(got, a) for got, a in zip(captured["adjs"], prep.adjs))
        + abs(len(captured["adjs"]) - len(prep.adjs))}


def conv_mismatch(adjs, captured):
    """Entries of the program's convolution graphs (its
    ``data["vgrnn_adjs"]``, captured by the job) that differ from
    ``conv_graph`` of the raw snapshots in float32, or that one side
    lacks."""
    return sum(_mismatch(got, conv_graph(a))
               for got, a in zip(captured, adjs)) + abs(len(captured)
                                                        - len(adjs))
