# coding: utf-8
"""Centrality prediction (port of
``ctgcn_tpu/evaluation/centrality_prediction.py``): per snapshot the
closeness, betweenness, eigenvector and k-core centralities of every node
-> ``<date>_centrality.csv`` (a file that exists is kept), then per method
and snapshot ridge regressions of each centrality on the embedding, out of
fold over ``split_fold`` folds for every alpha, scored by the MSE over the
centrality's mean, the least over the alphas -> ``<method>_mse_record.csv``.

Centralities, fits and errors run in float64 on ``device``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ctgcn_torch.data.formats import get_sp_adj_mat, sorted_dir
from ctgcn_torch.evaluation import linear, tables
from ctgcn_torch.evaluation.centrality import node_centralities
from ctgcn_torch.utils import check_and_make_path, resolve_device

CENTRALITY_LIST = ["closeness", "betweenness", "eigenvector", "kcore"]


class DataGenerator:
    def __init__(self, base_path, input_folder, output_folder, node_file,
                 file_sep="\t", device="cuda"):
        self.input_base_path = os.path.abspath(
            os.path.join(base_path, input_folder))
        self.output_base_path = os.path.abspath(
            os.path.join(base_path, output_folder))
        self.file_sep = file_sep
        self.full_node_list, _ = tables.read_nodes(base_path, node_file)
        self.device = resolve_device(device)
        check_and_make_path(self.output_base_path)

    def generate_node_samples(self, file, sep="\t"):
        date = file.split(".")[0]
        out_path = os.path.join(self.output_base_path,
                                date + "_centrality.csv")
        if os.path.exists(out_path):
            print("\t", date + "_centrality.csv exists")
            return
        adj = get_sp_adj_mat(os.path.join(self.input_base_path, file),
                             self.full_node_list, sep=sep)
        cent = node_centralities(adj, self.device)
        tables.write_table(out_path, ["node"] + CENTRALITY_LIST,
                           [np.arange(len(self.full_node_list))]
                           + [cent[c] for c in CENTRALITY_LIST],
                           self.file_sep)

    def generate_all_node_samples(self, sep="\t"):
        for f in sorted_dir(self.input_base_path):
            self.generate_node_samples(f, sep=sep)


class CentralityPredictor:
    def __init__(self, base_path, origin_folder, embedding_folder,
                 centrality_folder, output_folder, node_file, file_sep="\t",
                 alpha_list=None, split_fold=5, device="cuda"):
        self.origin_base_path = os.path.abspath(
            os.path.join(base_path, origin_folder))
        self.embedding_base_path = os.path.abspath(
            os.path.join(base_path, embedding_folder))
        self.centrality_base_path = os.path.abspath(
            os.path.join(base_path, centrality_folder))
        self.output_base_path = os.path.abspath(
            os.path.join(base_path, output_folder))
        self.file_sep = file_sep
        self.full_node_list, _ = tables.read_nodes(base_path, node_file)
        self.alpha_list = alpha_list or [0.01, 0.1, 1, 10]
        self.split_fold = split_fold
        self.device = resolve_device(device)
        check_and_make_path(self.output_base_path)

    def get_prediction_error(self, centrality_data, embeddings, date):
        """[date, the least normalized MSE over the alphas per
        centrality]."""
        pred = linear.ridge_cross_val_predict(embeddings, centrality_data,
                                              self.alpha_list,
                                              self.split_fold)
        mse = ((pred - centrality_data) ** 2).mean(1)       # [alphas, 4]
        err = (mse / centrality_data.mean(0)).cpu().numpy()
        # Python's min, as the JAX code takes it: a NaN error never wins
        return [date] + [min([float("inf")] + list(err[:, i]))
                         for i in range(len(CENTRALITY_LIST))]

    def centrality_prediction_all_time(self, method):
        print("method =", method)
        all_mse_list = []
        for f_name in sorted_dir(self.origin_base_path):
            date = f_name.split(".")[0]
            _, cols = tables.read_table(
                os.path.join(self.centrality_base_path,
                             date + "_centrality.csv"), self.file_sep)
            cur_embedding_path = os.path.join(self.embedding_base_path,
                                              method, f_name)
            if not os.path.exists(cur_embedding_path):
                continue
            centrality_data = torch.tensor(np.asarray(cols[1:], np.float64).T,
                                           device=self.device)
            embeddings = torch.from_numpy(tables.read_embedding(
                cur_embedding_path, self.full_node_list,
                self.file_sep)).to(self.device)
            all_mse_list.append(self.get_prediction_error(
                centrality_data, embeddings, date))
        for i, c in enumerate(CENTRALITY_LIST):
            vals = [r[1 + i] for r in all_mse_list]
            print(f"{c} avg:", np.mean(vals) if vals else float("nan"))
        tables.write_record(
            os.path.join(self.output_base_path, method + "_mse_record.csv"),
            ["date"] + CENTRALITY_LIST, all_mse_list)

    def centrality_prediction_all_method(self, method_list=None):
        print("Start graph centrality prediction!")
        if method_list is None:
            method_list = os.listdir(self.embedding_base_path)
        for method in method_list:
            self.centrality_prediction_all_time(method)
        print("Finish graph centrality prediction!")


def centrality_prediction(args, device="cuda"):
    """The ``cent_pred`` task of a config section.  ``worker`` is accepted
    and not used: the snapshots are taken one after another."""
    base_path = args["base_path"]
    origin_folder = args["origin_folder"]
    node_file = args["node_file"]
    centrality_data_folder = args["centrality_data_folder"]
    file_sep = args.get("file_sep", "\t")
    device = resolve_device(device)
    timing = {}
    t0 = time.time()
    if args.get("generate", True):
        DataGenerator(base_path, origin_folder, centrality_data_folder,
                      node_file, file_sep=file_sep,
                      device=device).generate_all_node_samples(sep=file_sep)
    timing["generate_seconds"] = time.time() - t0
    predictor = CentralityPredictor(
        base_path=base_path, origin_folder=origin_folder,
        embedding_folder=args["embed_folder"],
        centrality_folder=centrality_data_folder,
        output_folder=args["centrality_res_folder"], node_file=node_file,
        file_sep=file_sep, alpha_list=args.get("alpha_list", None),
        split_fold=args.get("split_fold", 5), device=device)
    t1 = time.time()
    predictor.centrality_prediction_all_method(
        method_list=args.get("method_list", None))
    timing["predict_seconds"] = time.time() - t1
    print("centrality prediction cost time:", timing["predict_seconds"],
          "seconds!")
    return timing
