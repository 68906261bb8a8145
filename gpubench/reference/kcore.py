"""K-core numbers by peeling, and the k-core subgraphs of a snapshot."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def core_numbers(adj):
    """Core number of every node (isolated nodes 0): remove every node of
    degree below k, again until none is left, then raise k."""
    a = (adj != 0).astype(np.int64).tocsr()
    deg = np.asarray(a.sum(axis=1)).ravel()
    alive = deg > 0
    core = np.zeros(adj.shape[0], np.int64)
    k = 1
    while alive.any():
        while True:
            out = np.flatnonzero(alive & (deg < k))
            if out.size == 0:
                break
            alive[out] = False
            lost = np.asarray(a[out].sum(axis=0)).ravel()
            deg = deg - lost
        core[alive] = k
        k += 1
    return core


def kcore_matrices(adj, core=None):
    """[(k, the weighted subgraph induced on {v : core(v) >= k})] for k =
    1 .. max core, as float64 CSR over all N nodes."""
    core = core_numbers(adj) if core is None else core
    out = []
    for k in range(1, int(core.max()) + 1):
        keep = sp.diags((core >= k).astype(np.float64))
        out.append((k, (keep @ adj @ keep).tocsr()))
    return out


def pyramid_slots(adj):
    """The slots a CTGCN layer diffuses over, max core first: the max-core
    subgraph plus I, then each smaller core's subgraph that differs from
    the one before it (an equal one adds nothing and is skipped)."""
    mats = [m for _, m in kcore_matrices(adj)][::-1]
    n = adj.shape[0]
    slots, prev = [], None
    for j, m in enumerate(mats):
        if j == 0:
            slots.append((m + sp.eye(n, format="csr")).tocsr())
        elif (m != prev).nnz:
            slots.append(m)
        prev = m
    return slots
