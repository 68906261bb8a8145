# coding: utf-8
"""Structural similarity prediction (port of
``ctgcn_tpu/evaluation/similarity_prediction.py``).

Data: per snapshot the Katz-style similarity of "Vertex similarity in
networks" (physics/0510143), ``S <- (alpha / lambda_1) A S + I`` for
``iter_num`` steps on the weighted adjacency (lambda_1 from ARPACK on the
host, started from the ones vector; the steps in float64 on ``device``,
each product summed in scipy's order), symmetrized, minus I, min-max
normalized, entries below 1e-6 set to 0 -> ``<date>_similarity.npz``.

Prediction: the Spearman correlation between that matrix and ``Z Z^T`` on
the nodes with any similarity, each min-max normalized and divided by its
sum -> ``<method>_mse_record.csv`` (column ``mse``, as the JAX package
names it).
"""
from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.data.formats import get_sp_adj_mat, sorted_dir
from ctgcn_torch.evaluation import linear, tables
from ctgcn_torch.utils import check_and_make_path, resolve_device


class DataGenerator:
    def __init__(self, base_path, input_folder, output_folder, node_file,
                 file_sep="\t", alpha=0.5, iter_num=100, device="cuda"):
        self.input_base_path = os.path.abspath(
            os.path.join(base_path, input_folder))
        self.output_base_path = os.path.abspath(
            os.path.join(base_path, output_folder))
        self.file_sep = file_sep
        self.full_node_list, _ = tables.read_nodes(base_path, node_file)
        if not 0 < alpha < 1:
            raise ValueError(f"alpha must lie in (0, 1), got {alpha}")
        self.alpha = alpha
        self.iter_num = iter_num
        self.device = resolve_device(device)
        check_and_make_path(self.output_base_path)

    def similarity(self, A):
        """The normalized similarity matrix (a float64 [n, n] tensor) of
        the scipy adjacency ``A``."""
        from scipy.sparse.linalg import eigsh

        A = sp.csr_matrix(A, dtype=np.float64)
        A.sort_indices()
        n = A.shape[0]
        # a fixed start: ARPACK's own random one moves lambda_1 by an ulp
        # from call to call, and with it which similarities tie
        lambda_1 = eigsh(A, k=1, which="LM", v0=np.ones(n),
                         return_eigenvectors=False)[0]
        # A's rows by falling degree, as [n, max degree] columns and values:
        # the k-th nonzeros of all rows then sit in the first rows_k rows
        deg = np.diff(A.indptr)
        order = np.argsort(-deg, kind="stable")
        slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
        row = np.empty(n, np.int64)
        row[order] = np.arange(n)
        cols = np.zeros((n, int(deg.max(initial=0))), np.int64)
        vals = np.zeros(cols.shape)
        cols[np.repeat(row, deg), slot] = A.indices
        vals[np.repeat(row, deg), slot] = A.data
        rows_k = [int(r) for r in (deg[:, None] > np.arange(cols.shape[1])
                                   ).sum(0)]
        cols = torch.from_numpy(cols).to(self.device)
        vals = torch.from_numpy(vals).to(self.device)
        row = torch.from_numpy(row).to(self.device)
        eye = torch.eye(n, dtype=torch.float64, device=self.device)
        dsd = torch.zeros(n, n, dtype=torch.float64, device=self.device)
        coef = self.alpha / lambda_1
        for _ in range(self.iter_num):
            # A @ dsd one nonzero of every row at a time, in each row's
            # column order from zero: scipy's sums, so that nodes tie
            # exactly where the JAX package's do
            prod = torch.zeros_like(dsd)
            for k, m in enumerate(rows_k):
                prod[:m] += vals[:m, k, None] * dsd[cols[:m, k]]
            dsd = coef * prod[row] + eye
        S = (dsd + dsd.T) / 2 - eye
        S = (S - S.min()) / (S.max() - S.min())
        S[S < 1e-6] = 0
        return S

    def generate_node_similarity(self, file):
        date = file.split(".")[0]
        A = get_sp_adj_mat(os.path.join(self.input_base_path, file),
                           self.full_node_list, sep=self.file_sep)
        S = self.similarity(A).cpu().numpy()
        sp.save_npz(os.path.join(self.output_base_path,
                                 date + "_similarity.npz"), sp.coo_matrix(S))

    def generate_node_similarity_all_time(self):
        for f in sorted_dir(self.input_base_path):
            self.generate_node_similarity(f)


def _normalized(m):
    """Min-max normalized, then divided by the sum.  The sum is numpy's
    (pairwise, on the host): a sum an ulp off rounds neighbouring values
    into ties or out of them, and the Spearman score moves with them."""
    m = (m - m.min()) / (m.max() - m.min())
    return m / float(np.sum(m.cpu().numpy()))


class SimilarityPredictor:
    def __init__(self, base_path, origin_folder, embedding_folder,
                 similarity_folder, output_folder, node_file, file_sep="\t",
                 device="cuda"):
        self.origin_base_path = os.path.abspath(
            os.path.join(base_path, origin_folder))
        self.embedding_base_path = os.path.abspath(
            os.path.join(base_path, embedding_folder))
        self.similarity_base_path = os.path.abspath(
            os.path.join(base_path, similarity_folder))
        self.output_base_path = os.path.abspath(
            os.path.join(base_path, output_folder))
        self.file_sep = file_sep
        self.full_node_list, _ = tables.read_nodes(base_path, node_file)
        self.device = resolve_device(device)
        check_and_make_path(self.output_base_path)

    @staticmethod
    def get_prediction_error(node_sim_mat, embedding_mat, date):
        """[date, Spearman correlation] of the similarity matrix and the
        embedding's inner products (float64 tensors)."""
        idx = torch.nonzero(node_sim_mat.sum(1) >= 1e-6).flatten()
        real = _normalized(node_sim_mat[idx][:, idx])
        # Z Z^T exactly symmetric, as numpy's product (a rank-k update) is:
        # the ranks of both matrices then tie in the same pairs
        pred = torch.triu(embedding_mat @ embedding_mat.T)
        pred = _normalized((pred + torch.triu(pred, 1).T)[idx][:, idx])
        return [date, linear.spearman(real, pred)]

    def similarity_prediction_all_time(self, method):
        print("method =", method)
        all_mse_list = []
        for f_name in sorted_dir(self.origin_base_path):
            date = f_name.split(".")[0]
            sim_path = os.path.join(self.similarity_base_path,
                                    date + "_similarity.npz")
            cur_embedding_path = os.path.join(self.embedding_base_path,
                                              method, f_name)
            if not (os.path.exists(sim_path)
                    and os.path.exists(cur_embedding_path)):
                continue
            node_sim_mat = torch.from_numpy(
                sp.load_npz(sim_path).toarray()).to(self.device)
            embedding_mat = torch.from_numpy(tables.read_embedding(
                cur_embedding_path, self.full_node_list,
                self.file_sep)).to(self.device)
            all_mse_list.append(self.get_prediction_error(
                node_sim_mat, embedding_mat, date))
        tables.write_record(
            os.path.join(self.output_base_path, method + "_mse_record.csv"),
            ["date", "mse"], all_mse_list)

    def similarity_prediction_all_method(self, method_list=None):
        print("Start node similarity prediction!")
        if method_list is None:
            method_list = os.listdir(self.embedding_base_path)
        for method in method_list:
            self.similarity_prediction_all_time(method)
        print("Finish node similarity prediction!")


def similarity_prediction(args, device="cuda"):
    """The ``sim_pred`` task of a config section.  ``worker`` is accepted
    and not used: the snapshots are taken one after another."""
    base_path = args["base_path"]
    origin_folder = args["origin_folder"]
    node_file = args["node_file"]
    similarity_data_folder = args["similarity_data_folder"]
    file_sep = args.get("file_sep", "\t")
    device = resolve_device(device)
    timing = {}
    t0 = time.time()
    if args.get("generate", True):
        DataGenerator(base_path, origin_folder, similarity_data_folder,
                      node_file, file_sep=file_sep,
                      alpha=args.get("alpha", 0.5),
                      iter_num=args.get("iter_num", 100),
                      device=device).generate_node_similarity_all_time()
    timing["generate_seconds"] = time.time() - t0
    predictor = SimilarityPredictor(
        base_path=base_path, origin_folder=origin_folder,
        embedding_folder=args["embed_folder"],
        similarity_folder=similarity_data_folder,
        output_folder=args["similarity_res_folder"], node_file=node_file,
        file_sep=file_sep, device=device)
    t1 = time.time()
    predictor.similarity_prediction_all_method(
        method_list=args.get("method_list", None))
    timing["predict_seconds"] = time.time() - t1
    print("node similarity prediction cost time:", timing["predict_seconds"],
          "seconds!")
    return timing
