# coding: utf-8
"""Padded neighbor tables, SAGE's neighbour sampling and GIN's max
pooling (port of ``neighbor_table_from_scipy``, ``sample_neighbors`` and
``masked_max_pool`` in ``ctgcn_tpu/ops/neighbors.py``).

A window's neighbor lists are one padded [T, N, max_deg] table and a
degree vector, built once on the host; sampling is a top-k over random
keys, pooling a gather and a masked max.
"""
from __future__ import annotations

import numpy as np
import torch


def neighbor_table_from_scipy(mats):
    """scipy adjacency list -> (nbr int64[T, N, D], deg int64[T, N]) on
    the host; D is the window's largest degree (at least 1), row i of
    snapshot t lists its columns in CSR order, padded with 0."""
    csrs = [m.tocsr() for m in mats]
    n = csrs[0].shape[0]
    max_deg = max(max(int(np.diff(c.indptr).max(initial=0)) for c in csrs),
                  1)
    nbr = np.zeros((len(csrs), n, max_deg), np.int64)
    deg = np.zeros((len(csrs), n), np.int64)
    for t, c in enumerate(csrs):
        d = np.diff(c.indptr)
        deg[t] = d
        slot = np.arange(c.nnz) - np.repeat(c.indptr[:-1], d)
        nbr[t, np.repeat(np.arange(n), d), slot] = c.indices
    return torch.from_numpy(nbr), torch.from_numpy(deg)


def sample_neighbors(nbr_t, deg_t, num_sample, generator):
    """Per-node neighbour sample of one snapshot's table: all neighbours
    when deg < num_sample (strictly), else ``num_sample`` distinct ones,
    uniformly without replacement: the top k of uniform keys from
    ``generator`` over the valid slots.  That is the JAX package's Gumbel
    top-k, since the Gumbel transform keeps the keys' order; the two
    frameworks' numbers differ, their distributions do not.

    Returns (idx [N, S] of ``nbr_t``'s dtype, mask bool [N, S]); the mask
    is false on the padding of short rows and on isolated nodes."""
    n, d = nbr_t.shape
    dev = nbr_t.device
    slots = torch.arange(num_sample, device=dev)[None, :]
    deg = deg_t[:, None]
    take_all = deg < num_sample
    keys = torch.rand((n, d), generator=generator, device=dev)
    valid = torch.arange(d, device=dev)[None, :] < deg
    top = torch.topk(keys.masked_fill(~valid, -1.0), min(num_sample, d),
                     dim=1).indices
    if top.shape[1] < num_sample:       # the table is narrower than S
        top = torch.nn.functional.pad(top, (0, num_sample - top.shape[1]))
    j = torch.where(take_all, slots.clamp_max(d - 1), top)
    idx = torch.gather(nbr_t, 1, j)
    mask = torch.where(take_all, slots < deg, True) & (deg > 0)
    return idx, mask


def masked_max_pool(x, nbr_t, deg_t):
    """Max of x over each node's neighbors (one snapshot's table); zero
    rows for isolated nodes.  ``amax`` splits the gradient evenly between
    tied maxima, as the JAX ``max`` does."""
    feats = x[nbr_t]                                        # [N, D, d]
    slot_mask = (torch.arange(nbr_t.shape[1], device=x.device)[None, :]
                 < deg_t[:, None])
    feats = torch.where(slot_mask[:, :, None], feats,
                        torch.tensor(float("-inf"), dtype=x.dtype,
                                     device=x.device))
    pooled = torch.amax(feats, dim=1)
    return torch.where(deg_t[:, None] > 0, pooled, torch.zeros_like(pooled))
