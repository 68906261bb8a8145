# coding: utf-8
"""Window loaders (port of ``ctgcn_tpu/data/loader.py``, the parts the
CGCN / CTGCN paths and the zoo's GCN, GIN, GAT and SAGE read): the k-core
pyramid bank of a window on its core backend, the walk tables as CSR
``WalkData``, the adjacency (raw or normalized, as scipy matrices or
``SparseGraph``s with the kernels' plans) and edge lists, the node
features (file, or built from degrees for the S-variants), and the node
and edge labels of the supervised types.

Everything here is built on the host; the driver moves the results to the
training device.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.data.formats import (get_sp_adj_mat, infer_names,
                                      pandas_column, sorted_dir)
from ctgcn_torch.losses import WalkData
from ctgcn_torch.ops.ell import build_ev_plans
from ctgcn_torch.ops.pyramid import (attach_ell_plans, build_core_pyramid,
                                      stack_pyramids)
from ctgcn_torch.ops.sparse import from_scipy, normalize_scipy_adj
from ctgcn_torch.utils import pad_bucket

CORE_BACKENDS = ("auto", "dense", "blocks", "ell", "pallas", "segment")
ADJ_BACKENDS = ("auto", "ell", "segment")
DEGREE_FEATURES = ("gaussian", "one-hot", "adj", "combine")


class DataLoader:
    """Per-window data loading over one dataset's artifact tree."""

    def __init__(self, node_list, max_time_num):
        self.max_time_num = max_time_num
        self.full_node_list = node_list
        self.node_num = len(node_list)
        self.node2idx_dict = dict(zip(node_list, range(self.node_num)))

    def _window(self, start_idx, duration):
        return range(start_idx, min(start_idx + duration, self.max_time_num))

    def get_scipy_adj_list(self, origin_base_path, start_idx, duration,
                           sep="\t", normalize=False, row_norm=False,
                           add_eye=False):
        """The symmetric adjacency (scipy) of each snapshot of the window:
        raw, plus I with ``add_eye``, then D^-1 A (``row_norm``) or
        D^-1/2 A D^-1/2 with ``normalize``."""
        f_list = sorted_dir(origin_base_path)
        out = []
        for i in self._window(start_idx, duration):
            mat = get_sp_adj_mat(os.path.join(origin_base_path, f_list[i]),
                                 self.full_node_list, sep=sep)
            if add_eye:
                mat = mat + sp.eye(mat.shape[0])
            if normalize:
                mat = normalize_scipy_adj(mat, row_norm=row_norm)
            out.append(mat)
        return out

    #: ``adj_backend: "auto"`` attaches the kernels' plans to a graph of at
    #: least this many nodes; below it the segment SpMM is fast enough to
    #: skip the plans' build (the JAX package's threshold)
    ELL_AUTO_NODES = 16384

    def get_date_adj_list(self, origin_base_path, start_idx, duration,
                          sep="\t", normalize=False, row_norm=False,
                          add_eye=False, adj_backend="auto"):
        """The window's adjacency (``get_scipy_adj_list``) as one host
        ``SparseGraph`` per snapshot.  ``adj_backend``: ``"ell"`` gives each
        graph the plan of its matrix and of its transpose (the CUDA
        kernels' inputs; the JAX package's ELL plans), ``EvPlan``s that
        also take edge values given per call (its ELL-ev plans),
        ``"segment"`` none, ``"auto"`` plans from ``ELL_AUTO_NODES`` nodes
        on."""
        return self.graphs_from_scipy(
            self.get_scipy_adj_list(origin_base_path, start_idx, duration,
                                    sep=sep, normalize=normalize,
                                    row_norm=row_norm, add_eye=add_eye),
            adj_backend=adj_backend)

    def graphs_from_scipy(self, mats, adj_backend="auto"):
        """One host ``SparseGraph`` per given scipy matrix, with the plan
        pair under ``adj_backend`` as ``get_date_adj_list`` gives it."""
        if adj_backend not in ADJ_BACKENDS:
            raise ValueError(f"adj_backend {adj_backend!r}, not one of "
                             f"{ADJ_BACKENDS}")
        graphs = [from_scipy(m) for m in mats]
        if adj_backend == "ell" or (adj_backend == "auto" and
                                    self.node_num >= self.ELL_AUTO_NODES):
            graphs = [dataclasses.replace(g, plan_fwd=fwd, plan_t=tr)
                      for g, (fwd, tr) in zip(graphs,
                                              map(build_ev_plans, graphs))]
        return tuple(graphs)

    def get_edge_list(self, origin_base_path, start_idx, duration, sep="\t"):
        """int64 [2, E_t] (row, col) of each snapshot's symmetric
        adjacency, both directions, in its COO order."""
        return [np.stack([m.row, m.col]).astype(np.int64)
                for m in self.get_scipy_adj_list(origin_base_path, start_idx,
                                                 duration, sep=sep)]

    def _label_list(self, label_base_path, start_idx, duration, sep,
                    n_ids):
        """Rows of the window's label files (a header row, then ``n_ids``
        node names and a label a row) as int64 [rows, n_ids + 1] arrays of
        node indices and label, and the number of distinct labels across
        the window."""
        files = sorted_dir(label_base_path)
        out, labels_seen = [], set()
        for i in self._window(start_idx, duration):
            with open(os.path.join(label_base_path, files[i])) as fp:
                rows = [line.split(sep)
                        for line in fp.read().splitlines()[1:] if line != ""]
            cols = [[self.node2idx_dict[v]
                     for v in infer_names([r[j] for r in rows])]
                    for j in range(n_ids)]
            labels = [int(r[n_ids]) for r in rows]
            labels_seen.update(labels)
            out.append(np.array(cols + [labels], np.int64).T.reshape(
                len(rows), n_ids + 1))
        return out, len(labels_seen)

    def get_node_label_list(self, nlabel_base_path, start_idx, duration,
                            sep="\t"):
        """Per snapshot int64 [n, 2] (node index, label), and the number
        of classes seen in the window."""
        return self._label_list(nlabel_base_path, start_idx, duration, sep, 1)

    def get_edge_label_list(self, elabel_base_path, start_idx, duration,
                            sep="\t"):
        """Per snapshot int64 [e, 3] (from index, to index, label), and the
        number of classes seen in the window."""
        return self._label_list(elabel_base_path, start_idx, duration, sep, 2)

    def get_feature_list(self, feature_base_path, start_idx, duration,
                         sep="\t"):
        """(xs, input_dim): ``None`` and N for identity features (never
        materialized), else the window's feature files (a header row, then
        one row of numbers per node) zero-padded to the widest, as a host
        f32 [T, N, D] tensor."""
        if feature_base_path is None:
            return None, self.node_num
        files = sorted_dir(feature_base_path)
        arrs = []
        for i in self._window(start_idx, duration):
            with open(os.path.join(feature_base_path, files[i])) as fp:
                lines = fp.read().splitlines()[1:]
            rows = [line.split(sep) for line in lines if line != ""]
            if len({len(r) for r in rows}) > 1:
                raise ValueError(f"{files[i]}: rows of different widths")
            # each column as pandas reads it (an int column exactly)
            arrs.append(np.stack([pandas_column(col) for col in zip(*rows)],
                                 axis=1))
        max_dim = max(a.shape[1] for a in arrs)
        xs = np.stack([np.pad(a, ((0, 0), (0, max_dim - a.shape[1])))
                       for a in arrs]).astype(np.float32)
        return torch.from_numpy(xs), max_dim

    def get_degree_feature_list(self, origin_base_path, start_idx, duration,
                                sep="\t", init_type="gaussian", std=1e-4,
                                rng=None):
        """Node features built from each snapshot's (weighted) degrees,
        [T, N, D] f32 on the host, D from the window's largest degree:
        'gaussian' N(degree, std) of width max_degree + 1, 'one-hot' the
        degree, 'adj' the adjacency rows, 'combine' gaussian then adj.
        ``rng``: the numpy ``RandomState`` (or ``Generator``) the gaussians
        come from (default ``np.random``); the draws are the JAX
        package's, call for call."""
        if init_type not in DEGREE_FEATURES:
            raise ValueError(f"unknown init_type {init_type!r}")
        rng = rng if rng is not None else np.random
        mats = self.get_scipy_adj_list(origin_base_path, start_idx, duration,
                                       sep=sep)
        degree_list = [np.asarray(m.sum(axis=1)).astype(np.int64).flatten()
                       for m in mats]
        max_degree = int(max(d.max() for d in degree_list))
        xs = []
        for mat, degrees in zip(mats, degree_list):
            if init_type == "one-hot":
                fea = np.zeros((self.node_num, max_degree + 1), np.float32)
                fea[np.arange(self.node_num), degrees] = 1.0
            elif init_type == "adj":
                fea = mat.toarray().astype(np.float32)
            else:
                fea = rng.normal(loc=degrees[:, None].astype(np.float64),
                                 scale=std,
                                 size=(self.node_num, max_degree + 1))
                if init_type == "combine":
                    fea = np.hstack([fea, mat.toarray()])
                fea = fea.astype(np.float32)
            xs.append(fea)
        stacked = torch.from_numpy(np.stack(xs))
        return stacked, int(stacked.shape[-1])

    def get_core_scipy_list(self, core_base_path, start_idx, duration,
                            max_core=-1):
        """Raw scipy core matrices per snapshot, max core first (truncate to
        ``max_core``, then reverse)."""
        date_dirs = sorted_dir(core_base_path)
        if start_idx >= len(date_dirs):
            raise ValueError(f"start_idx {start_idx} >= {len(date_dirs)} "
                             "core snapshots")
        out = []
        for i in self._window(start_idx, duration):
            ddir = os.path.join(core_base_path, date_dirs[i])
            f_list = sorted_dir(ddir)
            mc = len(f_list) if max_core == -1 else max_core
            f_list = f_list[:mc][::-1]
            out.append([sp.load_npz(os.path.join(ddir, f)) for f in f_list])
        return out

    def get_core_adj_list(self, core_base_path, start_idx, duration,
                          max_core=-1, core_backend="auto",
                          dense_budget_bytes=4 << 30, allow_blocks=True,
                          dense_dtype=None, dense_prec="highest",
                          keep=None):
        """The window's k-core pyramids as one stacked host ``CorePyramid``:
        K = the window's largest core count, +I on slot 0, delta-skip as
        ``valid``, the slot products on ``core_backend``.

        ``"auto"`` is the JAX package's policy: when the dense bank
        (T * K * N^2 entries of 4 bytes, 2 with a bf16 ``dense_dtype``)
        fits ``dense_budget_bytes``, core-sorted
        principal blocks (the dense bank with ``allow_blocks=False``, or
        where the slot supports do not nest); otherwise delta-encoded ELL
        plans, since a large graph's 128x128 blocks are nearly empty.
        ``"dense"``, ``"blocks"``, ``"ell"`` (delta-encoded), ``"pallas"``
        (BSR plans) and ``"segment"`` (padded COO) force one backend.  The
        COO is kept only for ``"segment"``: no other backend reads it.

        ``dense_dtype`` (``torch.bfloat16`` for the config's
        ``matmul_precision: "bf16"``) stores the dense bank and the blocks
        in bf16 and makes the ELL plans gather in bf16; ``dense_prec``
        ("highest" or "high") is the GEMM precision of an f32 bank.

        ``keep`` (a range of the window's snapshots; default all) builds
        only those, with the K and the backend chosen over the whole window
        (a part's timesteps under time sharding)."""
        if core_backend not in CORE_BACKENDS:
            raise ValueError(f"unknown core_backend {core_backend!r}")
        per_snap = self.get_core_scipy_list(core_base_path, start_idx,
                                            duration, max_core=max_core)
        num_slots = max(len(m) for m in per_snap)
        if core_backend == "auto":
            itemsize = 2 if dense_dtype == torch.bfloat16 else 4
            dense_bytes = (len(per_snap) * num_slots * self.node_num
                           * self.node_num * itemsize)
            fits = (dense_budget_bytes is not None
                    and dense_bytes <= dense_budget_bytes)
            core_backend = (("blocks" if allow_blocks else "dense") if fits
                            else "ell")
        bank = {"dense_dtype": dense_dtype, "dense_prec": dense_prec}
        if keep is not None:
            per_snap = [per_snap[t] for t in keep]
        pyramids = [
            build_core_pyramid(mats, self.node_num, num_slots=num_slots,
                               densify=core_backend == "dense",
                               build_blocks=core_backend == "blocks",
                               build_plans=core_backend == "pallas", **bank)
            for mats in per_snap]
        if core_backend == "blocks" and any(p.blocks is None
                                            for p in pyramids):
            # the supports do not nest somewhere: the whole window takes
            # the dense bank (cannot happen for true k-core pyramids)
            pyramids = [
                build_core_pyramid(mats, self.node_num, num_slots=num_slots,
                                   densify=True, **bank)
                for mats in per_snap]
        out = stack_pyramids(pyramids)
        if core_backend == "ell":
            out = attach_ell_plans(out, delta=True,
                                   bf16=dense_dtype == torch.bfloat16)
        if core_backend != "segment":
            out = dataclasses.replace(out, rows=None, cols=None, vals=None)
        return out

    def get_walk_data(self, walk_pair_base_path, node_freq_base_path,
                      start_idx, duration):
        """Walk co-occurrence and frequency artifacts as host ``WalkData``:
        per snapshot the partner lists in CSR (columns ascending within a
        node), the flat width bucket-padded to a power of two >= 4096, and
        the log of each node's count in the negative-sampling list."""
        walk_files = sorted_dir(walk_pair_base_path)
        freq_files = sorted_dir(node_freq_base_path)
        flats, offsets_t, degrees_t, logits_t = [], [], [], []
        width = 1
        for i in self._window(start_idx, duration):
            csr = sp.load_npz(
                os.path.join(walk_pair_base_path, walk_files[i])).tocsr()
            csr.sum_duplicates()
            csr.sort_indices()
            flats.append(csr.indices.astype(np.int32))
            offsets_t.append(csr.indptr[:-1].astype(np.int32))
            degrees_t.append(np.diff(csr.indptr).astype(np.int32))
            width = max(width, pad_bucket(csr.indices.shape[0], 4096))
            with open(os.path.join(node_freq_base_path, freq_files[i])) as fp:
                freq_list = json.load(fp)
            counts = np.bincount(np.asarray(freq_list, dtype=np.int64),
                                 minlength=self.node_num).astype(np.float64)
            with np.errstate(divide="ignore"):
                logits_t.append(np.log(counts).astype(np.float32))
        flat_arr = np.zeros((len(flats), width), np.int32)
        for t, flat in enumerate(flats):
            flat_arr[t, :flat.shape[0]] = flat
        return WalkData(
            nbr_flat=torch.from_numpy(flat_arr),
            nbr_offsets=torch.from_numpy(np.stack(offsets_t)),
            degrees=torch.from_numpy(np.stack(degrees_t)),
            neg_logits=torch.from_numpy(np.stack(logits_t)))
