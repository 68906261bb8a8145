# coding: utf-8
"""Random-walk structure generation, vectorized.

All ``node_num * walk_time`` walks advance in lockstep: one vectorized
inverse-CDF sample per hop over a padded per-node transition table, then a
single vectorized intra-walk pair expansion.  Every draw comes from the
numpy generator the caller passes, so a run is reproducible from its seed.

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

from ctgcn_torch.data.formats import get_sp_adj_mat, read_node_list, sorted_dir
from ctgcn_torch.utils import check_and_make_path


def simulate_walks(adj, walk_length, walk_time, rng, weighted=True):
    """Run ``walk_time`` walks of ``walk_length + 1`` nodes from every node.

    A walk from an isolated node stays in place; self-pairs are discarded
    downstream, so this equals stopping the walk.

    Args:
      rng: numpy ``RandomState`` or ``Generator``; one ``rng.random(n)``
        draw per hop.
    Returns int32[n_walks, walk_length + 1] node ids.
    """
    A = adj.tocsr()
    n = A.shape[0]
    deg = np.diff(A.indptr)
    max_deg = int(deg.max()) if n else 0

    # padded neighbor table + per-row transition CDF
    nbr = np.zeros((n, max(max_deg, 1)), dtype=np.int32)
    cdf = np.ones((n, max(max_deg, 1)), dtype=np.float64)
    for i in range(n):
        s, e = A.indptr[i], A.indptr[i + 1]
        if e > s:
            nbr[i, : e - s] = A.indices[s:e]
            w = A.data[s:e].astype(np.float64) if weighted else np.ones(e - s)
            c = np.cumsum(w)
            cdf[i, : e - s] = c / c[-1]
            cdf[i, e - s:] = 1.0

    starts = np.repeat(np.arange(n, dtype=np.int32), walk_time)
    walks = np.empty((starts.shape[0], walk_length + 1), dtype=np.int32)
    walks[:, 0] = starts
    cur = starts
    isolated = deg == 0
    for step in range(1, walk_length + 1):
        u = rng.random(cur.shape[0])
        # inverse CDF: first slot where cdf >= u
        slot = (cdf[cur] < u[:, None]).sum(axis=1)
        slot = np.minimum(slot, np.maximum(deg[cur] - 1, 0))
        nxt = nbr[cur, slot]
        nxt = np.where(isolated[cur], cur, nxt)
        walks[:, step] = nxt
        cur = nxt
    return walks


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
                walk_time, weighted, rng):
    """Single-snapshot walk job writing both artifacts."""
    walks = simulate_walks(spadj, walk_length, walk_time, rng,
                           weighted=weighted)
    pair_mat, freq = walk_pairs_and_freq(walks, spadj.shape[0])
    base = f_name.split(".")[0]
    with open(os.path.join(freq_dir_path, base + ".json"), "w") as fp:
        json.dump(negative_sampling_list(freq), fp)
    sp.save_npz(os.path.join(walk_dir_path, base + ".npz"), pair_mat.tocoo())


class WalkGenerator:
    """Per-snapshot walk generation; snapshot ``i`` draws from
    ``np.random.default_rng((seed, i))``."""

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
                        np.random.default_rng((self.seed, i)))
