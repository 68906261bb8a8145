# coding: utf-8
"""Edge classification (port of
``ctgcn_tpu/evaluation/edge_classification.py``): node classification's
splits, sweep and records over labelled edges, with Hadamard edge
features of the current snapshot's embedding."""
from __future__ import annotations

from ctgcn_torch.evaluation.node_classification import run_classification

EDGE_COLUMNS = ("from_id", "to_id", "label")


def edge_features(ids, embeddings):
    return embeddings[ids[:, 0]] * embeddings[ids[:, 1]]


def edge_classification(args, device="cuda"):
    """The ``edge_cls`` task of a config section.  ``worker`` is accepted
    and not used: the splits are generated file by file."""
    return run_classification(args, device, "elabel_folder",
                              "edgecls_data_folder", "edgecls_res_folder",
                              "do_edgecls", EDGE_COLUMNS, edge_features)
