"""The U-neg loss of the CTGCN authors' code: per snapshot, the batch
node's walk partners as positives (BCE with logits against 1) and a shared
set of drawn negatives whose scores collapse to one dot with their summed
embeddings (against 0, weighted by the node's positive count), over the
snapshot's positive slots; summed over the snapshots.

The random draws are the program's, given here and checked on their own by
``draw_faults``: ``j`` [T, B, S], the partner slots of each batch node
(all of them, in order, when it has at most S partners, else S distinct
ones), and ``neg`` [T, S], the negatives (nodes of a non-zero count).
Over all the checked batches, ``table_mismatch``, ``negative_fit`` and
``slot_fit`` check what they are drawn from: the program's sampling
table against the counts, the negatives against draws in proportion to
the counts, and the slots of nodes with more than S partners against
uniform ones."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F


class Tables:
    """The reference's walk tables of the window on the device."""

    def __init__(self, pairs, counts, device):
        self.indptr = [torch.from_numpy(p.indptr.astype(np.int64)).to(device)
                       for p in pairs]
        self.indices = [torch.from_numpy(p.indices.astype(np.int64)).to(device)
                        for p in pairs]
        self.deg = [ip[1:] - ip[:-1] for ip in self.indptr]
        self.counts = [torch.from_numpy(c).to(device) for c in counts]


def loss(embs, batch, mask, tabs, j, neg, Q):
    total = embs.new_zeros(())
    S = j.shape[-1]
    slot = torch.arange(S, device=embs.device)
    for t in range(embs.shape[0]):
        deg = tabs.deg[t][batch]
        valid = (slot[None, :] < deg.clamp(max=S)[:, None]) & mask[:, None]
        at = torch.where(valid, tabs.indptr[t][batch][:, None] + j[t], 0)
        partner = tabs.indices[t][at]
        e_b = embs[t, batch]
        pos = (e_b[:, None, :] * embs[t, partner]).sum(-1)
        count = valid.sum()
        if count == 0:
            continue
        vf = valid.float()
        pos_loss = (F.softplus(-pos) * vf).sum() / count
        neg_sum = embs[t, neg[t]].sum(0)
        neg_loss = (F.softplus((e_b * neg_sum).sum(-1)) * vf.sum(-1)).sum() \
            / count
        total = total + pos_loss + Q * neg_loss
    return total


def flops(n_batch, T, B, S, d):
    """(forward, backward) FLOPs of one batch's loss: the positive dots,
    the negatives' sum and the negative dots."""
    fwd = T * (2.0 * B * S * d + S * d + 2.0 * B * d)
    return fwd * n_batch, 2 * fwd * n_batch


def draw_faults(tabs, batch, j, neg):
    """Batch rows whose slots break the rule, and negatives of count 0."""
    bad = 0
    S = j.shape[-1]
    slot = torch.arange(S, device=j.device)
    for t in range(j.shape[0]):
        deg = tabs.deg[t][batch][:, None]
        jt = j[t]
        small = (deg <= S)[:, 0]
        bad += int((jt[small] != slot).any(-1).sum())
        big = jt[~small]
        srt = big.sort(-1).values
        wrong = ((big < 0) | (big >= deg[~small])).any(-1) \
            | (srt[:, 1:] == srt[:, :-1]).any(-1)
        bad += int(wrong.sum())
        bad += int((tabs.counts[t][neg[t]] <= 0).sum())
    return bad


#: a statistic of the draws further than this many standard deviations
#: from its expectation under the sampling rule is a fault
Z_LIMIT = 6.0


def table_mismatch(tabs, neg_logits):
    """Nodes whose weight in the program's sampling table (``neg_logits``
    [T, N], the log weights it draws the negatives from, up to a factor a
    snapshot) is not the reference's count."""
    bad = 0
    for t, c in enumerate(tabs.counts):
        lg = neg_logits[t].to(c.device, torch.float64)
        if lg.shape != c.shape:
            bad += c.numel()
            continue
        w = torch.exp(lg - lg.max()) * c.max()
        bad += int((torch.round(w) != c).sum())
    return bad


def negative_fit(tabs, negs):
    """z of the drawn negatives' summed log count (``negs``: [T, S] a
    batch) against its mean and variance when each is drawn in
    proportion to its count; a sampler that favours rare or common nodes
    moves it."""
    num = var = 0.0
    for t, c in enumerate(tabs.counts):
        cf = c.double()
        p = cf / cf.sum()
        lc = torch.log(cf.clamp(min=1))
        mu = float((p * lc).sum())
        v = float((p * lc * lc).sum()) - mu * mu
        x = torch.cat([n[t] for n in negs])
        num += float(lc[x].sum()) - x.numel() * mu
        var += x.numel() * v
    return num / math.sqrt(var) if var > 0 else 0.0


def slot_fit(tabs, batches, bins=10):
    """z (Wilson-Hilferty) of the chi-square of the partner slots j of
    batch nodes with more than S partners, over ``bins`` bins of j / deg,
    against slots drawn uniformly from 0..deg-1 (drawn without
    replacement within a node, the counts spread less, so the test only
    errs towards passing)."""
    obs = torch.zeros(bins, dtype=torch.float64)
    want = torch.zeros(bins, dtype=torch.float64)
    k = torch.arange(bins + 1)
    for b in batches:
        j = b["j"]
        S = j.shape[-1]
        for t in range(j.shape[0]):
            deg = tabs.deg[t][b["batch"]]
            big = (deg > S) & b["mask"]
            d, jt = deg[big].cpu(), j[t][big].cpu()
            at = (jt * bins // d[:, None]).clamp(0, bins - 1)
            obs += torch.bincount(at.flatten(), minlength=bins).double()
            # slots j < k d / bins: ceil(k d / bins) of them
            below = (k[None, :] * d[:, None] + bins - 1) // bins
            want += S * ((below[:, 1:] - below[:, :-1]).double()
                         / d[:, None].double()).sum(0)
    if float(want.sum()) == 0:
        return 0.0
    df = bins - 1
    chi2 = float(((obs - want) ** 2 / want.clamp(min=1e-12)).sum())
    c = 2.0 / (9 * df)
    return ((chi2 / df) ** (1 / 3) - (1 - c)) / math.sqrt(c)
