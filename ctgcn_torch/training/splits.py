# coding: utf-8
"""Train / validation / test splits of the supervised learning types, and
their AUC (port of the split generation and AUC helpers of
``ctgcn_tpu/training/driver.py``).

  * S-node / S-edge: each snapshot's label rows cut in file order at the
    config's ratios.
  * S-link-st / S-link-dy: each snapshot's edges (both directions)
    shuffled, cut at the ratios, and each part joined by as many sampled
    non-edges (label 0).  S-link-dy starts at snapshot 1: its edges are
    predicted from the embedding of the snapshot before.  The draws come
    from the numpy ``RandomState`` the caller passes, in the JAX package's
    order (per snapshot the shuffle, then the train, val and test
    sampling), so one seed gives both packages the same splits.

Each split is (items, labels, mask): [T, B] node indices or [T, B, 2] edge
endpoints (int64), [T, B] labels (int64 classes, or float32 0/1 for the
link types) and the bool [T, B] mask of the slots that hold an item,
padded to the longest snapshot.
"""
from __future__ import annotations

import numpy as np
import torch

from ctgcn_torch.evaluation.linear import roc_auc
from ctgcn_torch.utils import get_neg_edge_samples, sigmoid

SPLITS = ("train", "val", "test")


def _pad_stack(arr_list, pad_shape_tail, dtype):
    """Stack variable-length per-timestamp arrays into [T, B, ...] + mask."""
    B = max(max((a.shape[0] for a in arr_list), default=1), 1)
    out = np.zeros((len(arr_list), B) + pad_shape_tail, dtype=dtype)
    mask = np.zeros((len(arr_list), B), bool)
    for t, a in enumerate(arr_list):
        out[t, :a.shape[0]] = a
        mask[t, :a.shape[0]] = True
    return out, mask


def _cuts(n, train_ratio, val_ratio, test_ratio):
    tr = int(np.floor(n * train_ratio))
    va = int(np.floor(n * val_ratio))
    te = int(np.floor(n * test_ratio))
    return {"train": slice(0, tr), "val": slice(tr, tr + va),
            "test": slice(tr + va, tr + va + te)}


def _stack(splits, tail, label_dtype):
    out = {}
    for name in SPLITS:
        items, labels = splits[name]
        idx, mask = _pad_stack(items, tail, np.int64)
        lab, _ = _pad_stack(labels, (), label_dtype)
        out[name] = (torch.from_numpy(idx), torch.from_numpy(lab),
                     torch.from_numpy(mask))
    return out


def build_label_splits(label_list, train_ratio, val_ratio, test_ratio,
                       is_edge=False):
    """S-node / S-edge splits of the loader's label rows ([n, 2] node,
    label or [e, 3] from, to, label per snapshot)."""
    splits = {name: ([], []) for name in SPLITS}
    for labels in label_list:
        for name, cut in _cuts(labels.shape[0], train_ratio, val_ratio,
                               test_ratio).items():
            seg = labels[cut]
            splits[name][0].append(seg[:, :2] if is_edge else seg[:, 0])
            splits[name][1].append(seg[:, -1])
    return _stack(splits, (2,) if is_edge else (), np.int64)


def build_link_splits(edge_list, node_num, train_ratio, val_ratio,
                      test_ratio, learning_type, rng):
    """S-link-st / S-link-dy splits of the window's [2, E] edge lists,
    drawn from ``rng`` (numpy ``RandomState``)."""
    start = 1 if learning_type == "S-link-dy" else 0
    splits = {name: ([], []) for name in SPLITS}
    for t in range(start, len(edge_list)):
        edges = edge_list[t].T.copy()
        all_edge_dict = {(int(u), int(v)): 1 for u, v in edges if u != v}
        rng.shuffle(edges)
        for name, cut in _cuts(edges.shape[0], train_ratio, val_ratio,
                               test_ratio).items():
            pos = edges[cut]
            n_pos = pos.shape[0]
            both = get_neg_edge_samples(pos, n_pos, all_edge_dict, node_num,
                                        add_label=False, rng=rng)
            splits[name][0].append(both.astype(np.int64))
            splits[name][1].append(np.concatenate([np.ones(n_pos),
                                                   np.zeros(n_pos)]))
    return _stack(splits, (2,), np.float32)


def binary_auc(preds, labels, mask):
    """ROC AUC of the masked-in [T, B] logits (through the sigmoid, in
    their dtype) against 0/1 labels; NaN when one class is missing."""
    m = mask.reshape(-1).cpu()
    p = sigmoid(preds.detach()).reshape(-1).cpu()[m]
    try:
        return roc_auc(labels.reshape(-1).cpu()[m], p)
    except ValueError:
        return float("nan")


def multiclass_auc(preds, labels, mask, n_class):
    """Micro-averaged one-vs-rest ROC AUC of the masked-in [T, B, C]
    logits (through the softmax, in their dtype): every (item, class)
    pair counts once, labelled 1 for the item's class; NaN where that is
    not defined (one class missing, or two classes, where the one-column
    binarized labels do not match the two columns of scores)."""
    if n_class == 2:
        return float("nan")
    m = mask.reshape(-1).cpu()
    p = torch.softmax(preds.detach(), dim=-1).reshape(-1, preds.shape[-1])
    y = labels.reshape(-1).cpu()[m]
    onehot = y[:, None] == torch.arange(n_class)
    try:
        return roc_auc(onehot.reshape(-1), p.cpu()[m].reshape(-1))
    except ValueError:
        return float("nan")
