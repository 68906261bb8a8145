"""Snapshot edge lists to symmetric adjacency matrices, and the GCN
normalisation D^-1 (A + I)."""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp


def read_nodes(path):
    """Node names, one a line (the node files have no header)."""
    with open(path) as fp:
        return [line.strip() for line in fp if line.strip()]


def read_snapshot(path, index, sep="\t"):
    """The symmetric weighted adjacency [N, N] (CSR, float64, sorted
    column indices) of an edge file: a header line, then ``from to
    weight`` rows.  Self-loops are dropped; a pair named more than once
    takes the weight of its last row in file order."""
    n = len(index)
    with open(path) as fp:
        rows = [line.rstrip("\n").split(sep) for line in fp.readlines()[1:]]
    rows = [r for r in rows if len(r) >= 2]
    src = np.array([index[r[0]] for r in rows], np.int64)
    dst = np.array([index[r[1]] for r in rows], np.int64)
    w = np.array([float(r[2]) if len(r) > 2 else 1.0 for r in rows])
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    key = lo * n + hi
    # the last row of each pair: the first in reversed order
    _, first = np.unique(key[::-1], return_index=True)
    last = len(key) - 1 - first
    lo, hi, w = lo[last], hi[last], w[last]
    mat = sp.coo_matrix((np.concatenate([w, w]),
                         (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
                        shape=(n, n)).tocsr()
    mat.sort_indices()
    return mat


def read_window(data_dir, count, origin="1.format",
                node_file="nodes_set/nodes.csv"):
    """(node names, the first ``count`` snapshots' adjacency matrices)."""
    names = read_nodes(os.path.join(data_dir, node_file))
    index = {v: i for i, v in enumerate(names)}
    files = sorted(os.listdir(os.path.join(data_dir, origin)))[:count]
    return names, [read_snapshot(os.path.join(data_dir, origin, f), index)
                   for f in files]


def row_normalised(adj):
    """D^-1 (A + I), float64 CSR."""
    m = (adj + sp.eye(adj.shape[0], format="csr")).tocsr()
    d = np.asarray(m.sum(axis=1)).ravel()
    return (sp.diags(1.0 / d) @ m).tocsr()
