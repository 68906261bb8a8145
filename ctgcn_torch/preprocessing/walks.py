# coding: utf-8
"""Random-walk structure generation.

The walks come from the native kernel (``ctgcn_torch.native``), one
splitmix64 stream a walk from a 64-bit seed, as the JAX package's
preprocessing draws them; the same seed gives both packages the same walks.
A caller that passes a numpy generator gets the vectorized numpy sampler
instead: all ``node_num * walk_time`` walks advance in lockstep, one
inverse-CDF sample per hop over each row's CSR transition CDF (the walkers
and the CDF entries merged in one sort, so no [walks, max degree] table is
formed: at Enron's hub degree, 1147, that table holds 1.74 M walks × 1147
float64 CDF values, 16 GB a hop).  Either way a single vectorized
intra-walk pair expansion follows.

Artifacts:
  * ``<walk_pair_folder>/<date>.npz`` -- binary symmetric co-occurrence
    matrix over all intra-walk pairs of distinct nodes;
  * ``<node_freq_folder>/<date>.json`` -- negative-sampling list with node
    i repeated ``int((freq_i/total)**0.75 / 1e-5)`` times, where each pair
    occurrence bumps both endpoints.
"""
from __future__ import annotations

import json
import os

import numpy as np
import scipy.sparse as sp

from ctgcn_torch import native
from ctgcn_torch.data.formats import get_sp_adj_mat, read_node_list, sorted_dir
from ctgcn_torch.utils import check_and_make_path


def simulate_walks(adj, walk_length, walk_time, rng=None, weighted=True,
                   seed=0):
    """Run ``walk_time`` walks of ``walk_length + 1`` nodes from every node.

    A walk from an isolated node stays in place; self-pairs are discarded
    downstream, so this equals stopping the walk.

    Args:
      rng: ``None`` for the native kernel, seeded with ``seed`` (a 64-bit
        unsigned int); else a numpy ``RandomState`` or ``Generator`` for
        the numpy sampler, one ``rng.random(n)`` draw per hop.
    Returns int32[n_walks, walk_length + 1] node ids.
    """
    if rng is None:
        return native.simulate_walks(adj.tocsr(), walk_length, walk_time,
                                     seed, weighted=weighted)
    A = adj.tocsr()
    n = A.shape[0]
    indptr = A.indptr.astype(np.int64)
    deg = np.diff(indptr)
    # each row's transition CDF over its CSR entries: the cumulative sum of
    # its weights over their total, row by row
    cdf = np.empty(A.nnz, dtype=np.float64)
    for i in np.flatnonzero(deg):
        s, e = indptr[i], indptr[i + 1]
        w = A.data[s:e].astype(np.float64) if weighted else np.ones(e - s)
        c = np.cumsum(w)
        cdf[s:e] = c / c[-1]
    entry_row = np.repeat(np.arange(n), deg)

    starts = np.repeat(np.arange(n, dtype=np.int32), walk_time)
    walks = np.empty((starts.shape[0], walk_length + 1), dtype=np.int32)
    walks[:, 0] = starts
    cur = starts
    isolated = deg == 0
    for step in range(1, walk_length + 1):
        u = rng.random(cur.shape[0])
        # inverse CDF: the slot is the count of the row's CDF entries < u
        # (capped at the last entry); a walk at an isolated node stays
        nxt = cur.copy()
        moving = np.flatnonzero(~isolated[cur])
        rows = cur[moving]
        slot = np.minimum(
            _count_below(entry_row, cdf, indptr, rows, u[moving]),
            deg[rows] - 1)
        nxt[moving] = A.indices[indptr[rows] + slot]
        walks[:, step] = nxt
        cur = nxt
    return walks


def _count_below(entry_row, values, indptr, rows, u):
    """For each query i: how many entries of row ``rows[i]`` have a value
    < ``u[i]`` (entries sorted by row, ``indptr`` their row ranges).  The
    entries and queries are merged in one sort by (row, value), a query
    before the entries of equal value, so no [queries, max degree] table
    is formed."""
    n_e, n_q = values.shape[0], u.shape[0]
    kind = np.concatenate([np.ones(n_e, np.int8), np.zeros(n_q, np.int8)])
    order = np.lexsort((kind, np.concatenate([values, u]),
                        np.concatenate([entry_row, rows])))
    is_entry = kind[order] == 1
    entries_before = np.cumsum(is_entry) - is_entry
    at = np.flatnonzero(~is_entry)
    q = order[at] - n_e
    out = np.empty(n_q, np.int64)
    out[q] = entries_before[at] - indptr[rows[q]]
    return out


def walk_pairs_and_freq(walks, node_num):
    """All intra-walk (i<j) pairs of distinct nodes -> (binary symmetric
    co-occurrence COO, per-node frequency array)."""
    L = walks.shape[1]
    iu, ju = np.triu_indices(L, k=1)
    a = walks[:, iu].reshape(-1).astype(np.int64)
    b = walks[:, ju].reshape(-1).astype(np.int64)
    keep = a != b
    a, b = a[keep], b[keep]

    freq = (np.bincount(a, minlength=node_num)
            + np.bincount(b, minlength=node_num))

    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    key = np.unique(lo * np.int64(node_num) + hi)
    ulo = (key // node_num).astype(np.int32)
    uhi = (key % node_num).astype(np.int32)
    rows = np.concatenate([ulo, uhi])
    cols = np.concatenate([uhi, ulo])
    pair_mat = sp.coo_matrix(
        (np.ones(rows.shape[0], np.float64), (rows, cols)),
        shape=(node_num, node_num))
    return pair_mat, freq


def negative_sampling_list(freq, Z=1e-5):
    """Replicated unigram^0.75 list."""
    tot = freq.sum()
    if tot == 0:
        return []
    rep = ((freq / tot) ** 0.75 / Z).astype(np.int64)
    return np.repeat(np.arange(len(rep)), np.maximum(rep, 0)).tolist()


def random_walk(spadj, walk_dir_path, freq_dir_path, f_name, walk_length,
                walk_time, weighted, seed):
    """Single-snapshot walk job (native walks from ``seed``) writing both
    artifacts."""
    walks = simulate_walks(spadj, walk_length, walk_time, weighted=weighted,
                           seed=seed)
    pair_mat, freq = walk_pairs_and_freq(walks, spadj.shape[0])
    base = f_name.split(".")[0]
    with open(os.path.join(freq_dir_path, base + ".json"), "w") as fp:
        json.dump(negative_sampling_list(freq), fp)
    sp.save_npz(os.path.join(walk_dir_path, base + ".npz"), pair_mat.tocoo())


def snapshot_seed(seed, i):
    """The 64-bit walk seed of snapshot ``i`` (in file order) of a run
    seeded with ``seed``."""
    return int(np.random.SeedSequence((seed, i)).generate_state(
        1, np.uint64)[0])


class WalkGenerator:
    """Per-snapshot walk generation; snapshot ``i`` walks from
    ``snapshot_seed(seed, i)``, so a run is reproducible from the config's
    ``seed``.  The JAX package draws each snapshot's seed from the
    unseeded global ``np.random``; its walk tree equals this one exactly
    when it is given the same per-snapshot seeds."""

    def __init__(self, base_path, origin_folder, walk_pair_folder,
                 node_freq_folder, node_file, walk_time=100, walk_length=5,
                 weighted=True, seed=0):
        self.origin_base_path = os.path.abspath(
            os.path.join(base_path, origin_folder))
        self.walk_pair_base_path = os.path.abspath(
            os.path.join(base_path, walk_pair_folder))
        self.node_freq_base_path = os.path.abspath(
            os.path.join(base_path, node_freq_folder))
        self.walk_time = walk_time
        self.walk_length = walk_length
        self.weighted = weighted
        self.seed = seed
        self.full_node_list = read_node_list(
            os.path.abspath(os.path.join(base_path, node_file)))
        check_and_make_path(self.walk_pair_base_path)
        check_and_make_path(self.node_freq_base_path)

    def get_walk_info_all_time(self, sep="\t"):
        for i, f_name in enumerate(sorted_dir(self.origin_base_path)):
            spadj = get_sp_adj_mat(
                os.path.join(self.origin_base_path, f_name),
                self.full_node_list, sep=sep)
            random_walk(spadj, self.walk_pair_base_path,
                        self.node_freq_base_path, f_name, self.walk_length,
                        self.walk_time, self.weighted,
                        snapshot_seed(self.seed, i))
