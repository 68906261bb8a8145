# coding: utf-8
"""Skip-gram negative-sampling loss, the reconstruction loss of the
S-variants, the classification loss of the supervised learning types and
VGRNN's VAE loss (port of ``ctgcn_tpu/losses.py``).

The sampler and the loss arithmetic are separate functions, so a test can
hand both packages the same indices:

  * ``sample_uneg``: per timestamp, up to ``neg_num`` positive partners
    per batch node -- all of them when the node has at most ``neg_num``,
    else ``neg_num`` DISTINCT ones by Robert Floyd's algorithm (exact
    uniform subsets) -- and ``neg_num`` shared negatives drawn from the
    unigram^0.75 table;
  * ``uneg_loss``: BCEWithLogits(x, 1) = softplus(-x) on positive scores,
    and the negatives' scores collapse to one dot with the SUM of the
    negative embeddings, BCEWithLogits(x, 0) = softplus(x), weighted by the
    node's positive count.

``vae_loss`` takes the decoder's input z, not its [N, N] output, and the
target as a sparse graph: the JAX package densifies both a window at a
time (12.2 GB each at Math), here no [N, N] outlives its step.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F

from ctgcn_torch.ops.spmm import sddmm
from ctgcn_torch.training import profiling


@dataclasses.dataclass(frozen=True)
class WalkData:
    """Per-window walk tables (CSR).

    nbr_flat:    int32[T, P] concatenated partner ids, node-major (pad 0).
    nbr_offsets: int32[T, N] start of each node's run in nbr_flat.
    degrees:     int32[T, N] partner count per node.
    neg_logits:  float32[T, N] log of each node's negative-sampling weight
                 (-inf for weight 0).
    """

    nbr_flat: torch.Tensor
    nbr_offsets: torch.Tensor
    degrees: torch.Tensor
    neg_logits: torch.Tensor

    def to(self, device) -> "WalkData":
        return WalkData(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))


def sample_uneg(walk: WalkData, batch_idx, neg_num, generator):
    """Draw the loss's indices for every timestamp of the window.

    Returns (j int64[T, B, S]: partner slots within each batch node's run;
    neg_idx int64[T, S]: negative node ids), S = ``neg_num``.  All draws
    come from ``generator`` (on the tensors' device)."""
    dev = batch_idx.device
    S = neg_num
    deg = walk.degrees[:, batch_idx].long()                    # [T, B]
    chosen = torch.full((S,) + deg.shape, -1, dtype=torch.long, device=dev)
    for s in range(S):
        hi = torch.clamp(deg - S + s, min=0)
        u = torch.rand(deg.shape, generator=generator, device=dev)
        r = torch.minimum((u * (hi + 1)).long(), hi)            # U{0..hi}
        dup = (chosen[:s] == r).any(dim=0)
        chosen[s] = torch.where(dup, hi, r)
    slot = torch.arange(S, device=dev)
    j = torch.where(deg[..., None] <= S, slot, chosen.permute(1, 2, 0))
    probs = torch.exp(walk.neg_logits.float())
    neg_idx = torch.multinomial(probs, S, replacement=True,
                                generator=generator)
    return j, neg_idx


def uneg_loss(embs, batch_idx, batch_mask, walk: WalkData, j, neg_idx,
              Q=10.0):
    """Negative-sampling loss summed over timestamps, from given indices.

    embs [T, N, d]; batch_idx int[B] (padding entries arbitrary);
    batch_mask bool[B]; j, neg_idx from :func:`sample_uneg`."""
    T, S = j.shape[0], j.shape[2]
    tt = torch.arange(T, device=embs.device)
    deg = walk.degrees[:, batch_idx].long()                    # [T, B]
    slot = torch.arange(S, device=embs.device)
    slot_valid = ((slot < torch.clamp(deg, max=S)[..., None])
                  & batch_mask[None, :, None])                 # [T, B, S]
    # out-of-run slots of nodes with fewer than S partners are masked out
    # below; the clamp only keeps their reads inside the table
    flat_pos = torch.clamp(
        walk.nbr_offsets[:, batch_idx].long()[..., None] + j,
        max=walk.nbr_flat.shape[1] - 1)
    pos_idx = torch.gather(walk.nbr_flat.long(), 1,
                           flat_pos.reshape(T, -1)).reshape(j.shape)
    e_node = embs[:, batch_idx]                                # [T, B, d]
    e_pos = embs[tt[:, None, None], pos_idx]                   # [T, B, S, d]
    pos_score = (e_node[:, :, None, :] * e_pos).sum(-1)
    valid_f = slot_valid.float()
    sample_num = valid_f.sum(dim=(1, 2))
    denom = torch.clamp(sample_num, min=1)
    pos_loss = (F.softplus(-pos_score) * valid_f).sum(dim=(1, 2)) / denom
    s_neg = embs[tt[:, None], neg_idx].sum(dim=1)              # [T, d]
    neg_score = torch.einsum("tbd,td->tb", e_node, s_neg)
    neg_loss = (F.softplus(neg_score) * valid_f.sum(-1)).sum(-1) / denom
    loss_t = pos_loss + Q * neg_loss
    return torch.where(sample_num > 0, loss_t, 0.0).sum()


def negative_sampling_loss(embs, batch_idx, batch_mask, walk: WalkData,
                           generator, neg_num=20, Q=10.0):
    """Sample with ``generator`` and compute the loss.  While tracing is
    on, its forward and its backward are each a ``loss`` span."""
    backward = profiling.backward_span("loss")
    with profiling.span("loss"):
        embs = backward.enter(embs)
        j, neg_idx = sample_uneg(walk, batch_idx, neg_num, generator)
        return backward.exit(uneg_loss(embs, batch_idx, batch_mask, walk, j,
                                       neg_idx, Q=Q))


def reconstruction_loss(embs, trans, batch_idx=None, batch_mask=None):
    """MSE between the structure embedding ``trans`` and the node embedding
    ``embs`` ([T, N, d] each), summed over timestamps (the U-own loss of
    CGCN-S / CTGCN-S).  With ``batch_idx`` only those rows count; with
    ``batch_mask`` too, only the masked-in ones (padding entries of
    ``batch_idx`` are arbitrary)."""
    if batch_idx is None:
        return (trans - embs).square().mean(dim=(1, 2)).sum()
    diff2 = (trans[:, batch_idx] - embs[:, batch_idx]).square()
    if batch_mask is None:
        return diff2.mean(dim=(1, 2)).sum()
    mask = batch_mask.to(diff2.dtype)
    cnt = torch.clamp(mask.sum(), min=1) * embs.shape[-1]
    return ((diff2 * mask[None, :, None]).sum(dim=(1, 2)) / cnt).sum()


def classification_loss(preds, labels, mask=None):
    """Cross-entropy of [T, B, C] class logits, or binary cross-entropy of
    [T, B] logits (``softplus(p) - p * y``), and the accuracy: each a mean
    over a timestamp's masked-in slots (at least one counted), the losses
    summed over T and the accuracies averaged.

    Args:
      labels: [T, B] class ids, or 0/1 for binary logits.
      mask: optional bool [T, B] of the slots that hold an item.
    Returns (loss, accuracy), scalar tensors; the AUC comes from the
    logits on the host."""
    if preds.dim() == 2:
        y = labels.to(preds.dtype)
        per = F.softplus(preds) - preds * y
        correct = (preds > 0) == (y > 0.5)
    else:
        y = labels.long()
        per = -F.log_softmax(preds, dim=-1).gather(-1, y[..., None])[..., 0]
        correct = preds.argmax(dim=-1) == y
    correct = correct.to(preds.dtype)
    if mask is None:
        return per.mean(dim=1).sum(), correct.mean(dim=1).mean()
    m = mask.to(preds.dtype)
    cnt = torch.clamp(m.sum(dim=1), min=1)
    return ((per * m).sum(dim=1) / cnt).sum(), ((correct * m).sum(dim=1)
                                                / cnt).mean()


#: elements of z z^T formed at a time by the VAE loss's dense sum (2^28:
#: 1 GiB in f32, so a few row chunks at Math, N = 24,740)
GRAM_CHUNK_ELEMS = 1 << 28


def _row_chunks(n):
    rows = max(1, GRAM_CHUNK_ELEMS // n)
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


class _SoftplusGramSum(torch.autograd.Function):
    """sum_ij softplus((z z^T)_ij) for z [N, d], formed by row chunks and
    saving only z: the backward forms the chunks again, and since z z^T is
    symmetric, d/dz = (G + G^T) z = 2 G z with G = sigmoid(z z^T).  Its
    forward and its backward are each a ``gram`` span while tracing is
    on; each counts the pairs it formed (``vae.gram_pairs_fwd``,
    ``vae.gram_pairs_bwd``) and its chunks (``vae.gram_chunks``)."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        total = z.new_zeros(())
        chunks = _row_chunks(z.shape[0])
        with profiling.span("gram"):
            for rows in chunks:
                total += F.softplus(z[rows] @ z.T).sum()
        _count_gram(z, len(chunks), "fwd")
        return total

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        dz = torch.empty_like(z)
        chunks = _row_chunks(z.shape[0])
        with profiling.span("gram"):
            for rows in chunks:
                dz[rows] = torch.sigmoid_(z[rows] @ z.T) @ z
            dz.mul_(2 * g)
        _count_gram(z, len(chunks), "bwd")
        return dz


def _count_gram(z, chunks, way):
    n = z.shape[0]
    profiling.count("vae.gram_pairs_" + way, n * n)
    profiling.count("vae.gram_chunks", chunks)


def softplus_gram_sum(z):
    """sum over all (i, j) of softplus(<z_i, z_j>), differentiable in z;
    no [N, N] tensor is saved for the backward."""
    return _SoftplusGramSum.apply(z)


def vae_loss(enc_mean, enc_std, prior_mean, prior_std, z, targets,
             eps=1e-10):
    """VGRNN's VAE loss, summed over timestamps: per step the KL divergence
    of the posterior from the prior, (0.5 / N) * mean over rows of the sum
    over columns, ``eps`` inside every log and square, plus ``norm`` times
    the mean over all N^2 pairs of the weighted binary cross-entropy of
    the logits x = z_t z_t^T against the target A_t,
    -(posw * y * log sigmoid(x) + (1 - y) * log sigmoid(-x)), where
    ``posw = (N^2 - s) / s`` and ``norm = N^2 / (2 (N^2 - s))`` come from
    the target's sum of weights s (not its edge count).

    The cross-entropy is softplus(x) + y * ((posw - 1) * softplus(x) -
    posw * x): a dense sum of softplus(x) over all pairs
    (``softplus_gram_sum``) and a sum over the target's nonzeros of x there
    (the SDDMM of z with itself).

    Args: enc_mean, enc_std, prior_mean, prior_std, z: [T, N, d];
    targets: T ``SparseGraph``s, the raw weighted adjacency.  While tracing
    is on, its forward and its backward are each a ``loss`` span; it
    counts the target nonzeros it scores (``vae.sddmm_nnz``)."""
    n = z.shape[1]
    tot = float(n) * n
    backward = profiling.backward_span("loss")
    with profiling.span("loss"):
        enc_mean, enc_std, prior_mean, prior_std, z = backward.enter(
            enc_mean, enc_std, prior_mean, prior_std, z)
        loss = z.new_zeros(())
        for t, target in enumerate(targets):
            em, es, pm, ps = (enc_mean[t], enc_std[t], prior_mean[t],
                              prior_std[t])
            kld_el = (2 * torch.log(ps + eps) - 2 * torch.log(es + eps)
                      + ((es + eps).square() + (em - pm).square())
                      / (ps + eps).square() - 1)
            kld = (0.5 / n) * kld_el.sum(dim=1).mean()
            y = target.vals.to(z.dtype)
            s = y.sum()
            posw = (tot - s) / s
            norm = tot / ((tot - s) * 2.0)
            x_e = sddmm(target, z[t], z[t])
            profiling.count("vae.sddmm_nnz", y.numel())
            bce_sum = softplus_gram_sum(z[t]) + (
                y * ((posw - 1) * F.softplus(x_e) - posw * x_e)).sum()
            loss = loss + kld + norm * bce_sum / tot
        return backward.exit(loss)
