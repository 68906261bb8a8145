"""The random-walk tables of the U-neg loss: weighted walks with one
splitmix64 stream a walk, the co-occurrence pairs within each walk and the
unigram^0.75 negative-sampling counts.

A walk is defined by its 64-bit seed alone: walk w (start node w //
walk_time) draws from the stream seeded ``seed ^ (0xD1B54A32D192ED03 *
(w + 1))``, whose first output is discarded; each hop from a node with
neighbours draws u = (next >> 11) / 2^53 and takes the first neighbour, in
ascending id order, whose inclusive running weight sum reaches u times the
row's total.  A walk at a node without neighbours stays there and draws
nothing.  Snapshot i of a run seeded s walks from the first 64-bit word of
``numpy.random.SeedSequence((s, i))``."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_WALK = np.uint64(0xD1B54A32D192ED03)


def snapshot_seed(seed, i):
    return int(np.random.SeedSequence((seed, i)).generate_state(
        1, np.uint64)[0])


def _next(state):
    """(advanced state, output) of splitmix64, elementwise."""
    state = state + _GAMMA
    z = (state ^ (state >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return state, z ^ (z >> np.uint64(31))


def walks(adj, walk_length, walk_time, seed):
    """int64 [N * walk_time, walk_length + 1] node ids; row w starts at
    w // walk_time."""
    a = adj.tocsr()
    a.sort_indices()
    n = a.shape[0]
    indptr = a.indptr.astype(np.int64)
    indices = a.indices.astype(np.int64)
    cumw = np.zeros(a.nnz)
    for r in np.flatnonzero(np.diff(indptr)):
        cumw[indptr[r]:indptr[r + 1]] = np.cumsum(
            a.data[indptr[r]:indptr[r + 1]].astype(np.float64))
    n_walks = n * walk_time
    with np.errstate(over="ignore"):
        w = np.arange(n_walks, dtype=np.uint64)
        state = np.uint64(seed) ^ (_WALK * (w + np.uint64(1)))
        state, _ = _next(state)
    cur = (np.arange(n_walks) // walk_time).astype(np.int64)
    out = np.empty((n_walks, walk_length + 1), np.int64)
    out[:, 0] = cur
    for step in range(1, walk_length + 1):
        s, e = indptr[cur], indptr[cur + 1]
        move = np.flatnonzero(e > s)
        with np.errstate(over="ignore"):
            st, z = _next(state[move])
        state[move] = st
        u = (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53
        target = u * cumw[e[move] - 1]
        lo, hi = s[move].copy(), e[move] - 1
        while True:
            open_ = lo < hi
            if not open_.any():
                break
            mid = (lo + hi) >> 1
            below = cumw[mid] < target
            lo = np.where(open_ & below, mid + 1, lo)
            hi = np.where(open_ & ~below, mid, hi)
        cur = cur.copy()
        cur[move] = indices[lo]
        out[:, step] = cur
    return out


def tables(walk_rows, n):
    """(pairs: binary symmetric CSR of the distinct node pairs that share
    a walk, counts: int64 [N] negative-sampling count of each node).  A
    node's frequency counts every pair it is in; its count is
    int((freq / total)^0.75 / 1e-5)."""
    L = walk_rows.shape[1]
    i, j = np.triu_indices(L, k=1)
    a, b = walk_rows[:, i].ravel(), walk_rows[:, j].ravel()
    keep = a != b
    a, b = a[keep], b[keep]
    freq = np.bincount(a, minlength=n) + np.bincount(b, minlength=n)
    key = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    lo, hi = key // n, key % n
    pairs = sp.coo_matrix((np.ones(2 * key.size), (np.concatenate([lo, hi]),
                                                   np.concatenate([hi, lo]))),
                          shape=(n, n)).tocsr()
    pairs.sort_indices()
    total = freq.sum()
    counts = ((freq / total) ** 0.75 / 1e-5).astype(np.int64)
    return pairs, np.maximum(counts, 0)
