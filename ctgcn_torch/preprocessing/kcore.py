# coding: utf-8
"""K-core decomposition.

Core numbers come from the native bucket-queue peel (``ctgcn_torch.native``,
as the JAX package's preprocessing runs it); the vectorized numpy peel
beside it is the reference that tests and ``chip_smoke.py`` hold it
against.  Each k-core subgraph is the induced weighted submatrix on
``{v : core(v) >= k}``, so one peeling pass serves every k.  Artifacts:
``<core_folder>/<date>/<k>.npz`` scipy matrices over the full node list,
file names zero-padded to the max core width.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from ctgcn_torch import native
from ctgcn_torch.data.formats import get_sp_adj_mat, read_node_list, sorted_dir
from ctgcn_torch.utils import check_and_make_path, get_format_str


def _csr_rows_concat(indptr, indices, rows):
    """Concatenated neighbor lists of ``rows`` from CSR structure, without a
    Python per-row loop (repeat/arange range-gather)."""
    starts = indptr[rows]
    counts = indptr[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return indices[:0]
    offsets = np.repeat(np.cumsum(counts) - counts, counts)
    flat = np.repeat(starts, counts) + (np.arange(total) - offsets)
    return indices[flat]


def _structure(adj):
    A = adj.tocsr().astype(bool).astype(np.int8)
    A.eliminate_zeros()
    return A


def core_numbers(adj) -> np.ndarray:
    """Exact k-core numbers by the native bucket-queue peel (weights
    ignored; isolated nodes get core 0)."""
    return native.core_numbers(_structure(adj))


def peel_core_numbers(adj) -> np.ndarray:
    """The same numbers in numpy: O(E) peeling by degree waves."""
    A = _structure(adj)
    indptr, indices = A.indptr, A.indices
    n = A.shape[0]
    deg = np.diff(indptr).astype(np.int64)
    core = np.zeros(n, dtype=np.int64)
    alive = deg > 0
    n_alive = int(alive.sum())
    k = 1
    while n_alive:
        while True:
            wave = np.flatnonzero(alive & (deg < k))
            if wave.size == 0:
                break
            alive[wave] = False
            n_alive -= wave.size
            nbrs = _csr_rows_concat(indptr, indices, wave)
            np.subtract.at(deg, nbrs, 1)
        if not n_alive:
            break
        core[alive] = k
        k += 1
    return core


def kcore_subgraph(adj, core, k):
    """Weighted induced subgraph on nodes with core number >= k, over the
    full node index space (zero rows for excluded nodes)."""
    mask = (core >= k).astype(adj.dtype if adj.dtype.kind == "f" else np.float64)
    d = sp.diags(mask)
    return (d @ adj.tocsr() @ d).tocoo()


class StructureInfoGenerator:
    """Per-snapshot k-core pyramid generation."""

    def __init__(self, base_path, origin_folder, core_folder, node_file):
        self.origin_base_path = os.path.abspath(
            os.path.join(base_path, origin_folder))
        self.core_base_path = os.path.abspath(
            os.path.join(base_path, core_folder))
        self.full_node_list = read_node_list(
            os.path.abspath(os.path.join(base_path, node_file)))
        check_and_make_path(self.core_base_path)

    def get_kcore_graph(self, input_file, output_dir, sep="\t"):
        adj = get_sp_adj_mat(os.path.join(self.origin_base_path, input_file),
                             self.full_node_list, sep=sep)
        core = core_numbers(adj)
        max_core = int(core.max()) if core.size else 0
        check_and_make_path(output_dir)
        fmt = get_format_str(max_core)
        for k in range(1, max_core + 1):
            sp.save_npz(os.path.join(output_dir, fmt.format(k) + ".npz"),
                        kcore_subgraph(adj, core, k).tocsr())

    def get_kcore_graph_all_time(self, sep="\t"):
        for f_name in sorted_dir(self.origin_base_path):
            self.get_kcore_graph(
                f_name,
                os.path.join(self.core_base_path, f_name.split(".")[0]),
                sep=sep)
