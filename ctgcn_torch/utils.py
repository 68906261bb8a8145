# coding: utf-8
"""Shared helpers: device selection, path helpers, method registries,
padding buckets, the sigmoid and negative edge sampling (the port's own
copy of ``ctgcn_tpu/utils.py``)."""
import os

import numpy as np
import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no GPU (the port never falls back to the CPU by itself).
    Under ``torchrun`` a bare "cuda" is ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in \
            os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_and_make_path(to_make):
    """Create a directory (and parents) if it does not exist."""
    if to_make == "" or to_make is None:
        return
    os.makedirs(to_make, exist_ok=True)


def get_format_str(cnt):
    """Zero-padded format string sized to ``cnt`` (file ordering is
    load-bearing: core files sort lexicographically)."""
    max_bit = 0
    while cnt > 0:
        cnt //= 10
        max_bit += 1
    return "{:0>" + str(max_bit) + "d}"


STATIC_GNN_METHODS = (
    "GCN", "TgGCN", "GAT", "TgGAT", "SAGE", "TgSAGE", "GIN", "TgGIN",
    "PGNN", "CGCN-C", "CGCN-S",
)
DYNAMIC_GNN_METHODS = ("GCRN", "EvolveGCN", "VGRNN", "CTGCN-C", "CTGCN-S")
NON_GNN_METHODS = ("DynGEM", "DynAE", "DynRNN", "DynAERNN", "TIMERS")


def get_supported_methods():
    """Every method name the JAX package's CLI accepts, all of which the
    port runs: the CTGCN family and the zoo through
    ``training.driver.gnn_embedding`` (``PORTED_METHODS``), DynGEM, DynAE,
    DynRNN and DynAERNN through ``nn.dynae.dyngem_embedding`` and TIMERS
    through ``nn.timers.timers_embedding``."""
    return dict.fromkeys(
        NON_GNN_METHODS + STATIC_GNN_METHODS + DYNAMIC_GNN_METHODS, 1)


def pad_bucket(n, minimum=256):
    """Bucketed padding size: next power of two >= max(n, minimum)."""
    n = max(int(n), int(minimum))
    return 1 << (n - 1).bit_length()


def sigmoid(x):
    """``1 / (1 + exp(-x))`` of a tensor, the JAX package's formula (it
    saturates to exactly 0 and 1 as numpy's does)."""
    return 1.0 / (1.0 + torch.exp(-x))


def get_neg_edge_samples(pos_edges, edge_num, all_edge_dict, node_num,
                         add_label=True, rng=None):
    """Rejection-sample ``edge_num`` non-edges and stack them under
    ``pos_edges``.  The draws are the JAX package's, call for call (two
    ``rng.choice(node_num)`` an attempt), so one ``RandomState`` gives the
    same rows in both packages."""
    rng = rng if rng is not None else np.random
    neg_edge_dict = {}
    neg_edge_list = []
    cnt = 0
    while cnt < edge_num:
        from_id = int(rng.choice(node_num))
        to_id = int(rng.choice(node_num))
        if from_id == to_id:
            continue
        if ((from_id, to_id) in all_edge_dict
                or (to_id, from_id) in all_edge_dict):
            continue
        if ((from_id, to_id) in neg_edge_dict
                or (to_id, from_id) in neg_edge_dict):
            continue
        neg_edge_dict[(from_id, to_id)] = 1
        if add_label:
            neg_edge_list.append([from_id, to_id, 0])
        else:
            neg_edge_list.append([from_id, to_id])
        cnt += 1
    neg_edges = np.array(neg_edge_list)
    return np.vstack([pos_edges, neg_edges])
