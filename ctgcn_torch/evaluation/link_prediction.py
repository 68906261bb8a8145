# coding: utf-8
"""Link prediction (port of ``ctgcn_tpu/evaluation/link_prediction.py``).

* ``<date>_{train,val,test}.csv`` edge samples, each positive set followed
  by as many rejection-sampled negatives; the numpy calls are the JAX
  package's, in its order, from one ``RandomState`` per (rep, file)
  seeded by crc32, so the files are byte-identical to its own;
* for snapshot t >= 1 the edges of t are scored with the embedding
  exported for t - 1 (a missing embedding skips the date);
* per measure (Avg/Had/L1/L2), balanced logistic regressions over the C
  list, the last C reaching the best validation AUC kept; the sigmoid
  measure scores without a fit.  Test AUCs -> ``<method>_auc_record.csv``;
  the summary is the mean Had AUC of the last 4 dates.

Fits and AUCs run in float64 on ``device``; the splits are host numpy.
"""
from __future__ import annotations

import os
import time
import zlib

import numpy as np
import torch

from ctgcn_torch.data.formats import infer_names, sorted_dir
from ctgcn_torch.evaluation import linear, tables
from ctgcn_torch.utils import (check_and_make_path, get_neg_edge_samples,
                               resolve_device, sigmoid)

MEASURES = ("Avg", "Had", "L1", "L2", "sigmoid")


def rep_rng(seed, file):
    """The (rep, file) stream of the JAX package's data generators, or the
    global numpy stream when ``seed`` is None."""
    if seed is None:
        return np.random
    return np.random.RandomState(
        zlib.crc32(f"{seed}:{file}".encode()) & 0x7FFFFFFF)


class DataGenerator:
    def __init__(self, base_path, input_folder, output_folder, node_file,
                 file_sep="\t", train_ratio=0.5, val_ratio=0.2,
                 test_ratio=0.3, seed=None):
        self.input_base_path = os.path.join(base_path, input_folder)
        self.output_base_path = os.path.join(base_path, output_folder)
        self.file_sep = file_sep
        self.full_node_list, self.node2idx_dict = tables.read_nodes(
            base_path, node_file)
        self.node_num = len(self.full_node_list)
        if train_ratio + test_ratio + val_ratio > 1.0:
            raise ValueError("train + val + test ratios exceed 1")
        self.train_ratio = train_ratio
        self.val_ratio = val_ratio
        self.test_ratio = test_ratio
        self.seed = seed
        check_and_make_path(self.output_base_path)

    def generate_edge_sample(self, file, sep="\t"):
        rng = rep_rng(self.seed, file)
        date = file.split(".")[0]
        with open(os.path.join(self.input_base_path, file)) as fp:
            rows = [line.split(sep) for line in fp.read().splitlines()[1:]
                    if line != ""]
        src = np.array([self.node2idx_dict[v]
                        for v in infer_names([r[0] for r in rows])], np.int64)
        dst = np.array([self.node2idx_dict[v]
                        for v in infer_names([r[1] for r in rows])], np.int64)
        # both directions, label 1
        edges = np.stack([np.concatenate([src, dst]),
                          np.concatenate([dst, src]),
                          np.ones(2 * len(src), np.int64)], axis=1)
        all_edge_dict = {(int(u), int(v)): 1 for u, v, _ in edges}
        rng.shuffle(edges)
        edge_num = edges.shape[0]
        test_num = int(np.floor(edge_num * self.test_ratio))
        val_num = int(np.floor(edge_num * self.val_ratio))
        train_num = int(np.floor(
            (edge_num - test_num - val_num) * self.train_ratio))
        val_edges = edges[:val_num]
        test_edges = edges[val_num:val_num + test_num]
        train_edges = edges[val_num + test_num:val_num + test_num + train_num]
        for name, pos, n in (("train", train_edges, train_num),
                             ("test", test_edges, test_num),
                             ("val", val_edges, val_num)):
            both = get_neg_edge_samples(pos, n, all_edge_dict, self.node_num,
                                        rng=rng)
            tables.write_table(
                os.path.join(self.output_base_path, f"{date}_{name}.csv"),
                ["from_id", "to_id", "label"], both.T, self.file_sep)

    def generate_edge_samples_all_time(self, sep="\t"):
        """Every snapshot's splits, one file after another (each file has
        its own stream, so the order changes nothing)."""
        print("Start generating edge samples!")
        for f in sorted_dir(self.input_base_path):
            self.generate_edge_sample(f, sep=sep)
        print("Generate edge samples finish!")


def edge_features(edges, emb, measure_list):
    """Edge features per measure of the [n, >= 2] id tensor ``edges``."""
    zi, zj = emb[edges[:, 0]], emb[edges[:, 1]]
    feats = {}
    for measure in measure_list:
        if measure not in MEASURES:
            raise ValueError(f"unknown measure {measure!r}")
        if measure == "Avg":
            feats[measure] = (zi + zj) / 2
        elif measure == "Had":
            feats[measure] = zi * zj
        elif measure == "L1":
            feats[measure] = (zi - zj).abs()
        elif measure == "L2":
            feats[measure] = (zi - zj) ** 2
        else:  # a score, no model fitted
            feats[measure] = sigmoid((zi * zj).sum(1))
    return feats


class LinkPredictor:
    def __init__(self, base_path, origin_folder, embedding_folder,
                 lp_edge_folder, output_folder, node_file, file_sep="\t",
                 C_list=None, measure_list=None, max_iter=5000,
                 device="cuda"):
        self.origin_base_path = os.path.join(base_path, origin_folder)
        self.embedding_base_path = os.path.join(base_path, embedding_folder)
        self.lp_edge_base_path = os.path.join(base_path, lp_edge_folder)
        self.output_base_path = os.path.join(base_path, output_folder)
        self.file_sep = file_sep
        self.measure_list = measure_list or ["Avg", "Had", "L1", "L2"]
        self.full_node_list, _ = tables.read_nodes(base_path, node_file)
        self.C_list = C_list or [0.01, 0.1, 1, 10]
        self.max_iter = max_iter
        self.device = resolve_device(device)
        check_and_make_path(self.output_base_path)

    def _edges(self, date, kind):
        path = os.path.join(self.lp_edge_base_path, f"{date}_{kind}.csv")
        cols = tables.read_split(path, self.file_sep)
        return torch.from_numpy(np.stack(cols[:3], 1)).to(self.device)

    def train(self, train_edges, val_edges, embeddings):
        """Per fitted measure, the weights of the last C whose validation
        AUC reaches the best."""
        train_labels, val_labels = train_edges[:, 2], val_edges[:, 2]
        train_feats = edge_features(train_edges, embeddings,
                                    self.measure_list)
        val_feats = edge_features(val_edges, embeddings, self.measure_list)
        model_dict = {}
        for measure in self.measure_list:
            if measure == "sigmoid":
                continue
            w = linear.fit_logistic(train_feats[measure], train_labels,
                                    self.C_list, self.max_iter)
            pred = linear.predict_logistic(w, val_feats[measure])
            best_auc, best = 0.0, None
            for b in range(len(self.C_list)):
                auc = linear.roc_auc(val_labels, pred[b])
                if auc >= best_auc:
                    best_auc, best = auc, b
            model_dict[measure] = w[best:best + 1]
        return model_dict

    def test(self, test_edges, embeddings, model_dict, date):
        test_labels = test_edges[:, 2]
        test_feats = edge_features(test_edges, embeddings, self.measure_list)
        auc_list = [date]
        for measure in self.measure_list:
            if measure == "sigmoid":
                pred = test_feats[measure]
            else:
                pred = linear.predict_logistic(model_dict[measure],
                                               test_feats[measure])[0]
            auc_list.append(linear.roc_auc(test_labels, pred))
        return auc_list

    def link_prediction_all_time(self, method):
        print("method =", method)
        f_list = sorted_dir(self.origin_base_path)
        all_auc_list = []
        for i, f_name in enumerate(f_list):
            if i == 0:
                continue
            date = f_name.split(".")[0]
            pre_embedding_path = os.path.join(
                self.embedding_base_path, method, f_list[i - 1])
            if not os.path.exists(pre_embedding_path):
                continue
            train_edges, val_edges, test_edges = (
                self._edges(date, k) for k in ("train", "val", "test"))
            embeddings = torch.from_numpy(tables.read_embedding(
                pre_embedding_path, self.full_node_list,
                self.file_sep)).to(self.device)
            model_dict = self.train(train_edges, val_edges, embeddings)
            all_auc_list.append(
                self.test(test_edges, embeddings, model_dict, date))
        if "Had" in self.measure_list:
            had_pos = 1 + self.measure_list.index("Had")
        else:
            had_pos = 2
        last = [r[had_pos] for r in all_auc_list[-4:] if had_pos < len(r)]
        print(f"method = {method}, average AUC of Had: "
              f"{np.mean(last) if last else float('nan')}")
        tables.write_record(
            os.path.join(self.output_base_path, method + "_auc_record.csv"),
            ["date"] + self.measure_list, all_auc_list)

    def link_prediction_all_method(self, method_list=None):
        print("Start link prediction!")
        if method_list is None:
            method_list = os.listdir(self.embedding_base_path)
        for method in method_list:
            self.link_prediction_all_time(method)
        print("Finish link prediction!")


def aggregate_results(base_path, lp_res_folder, start_idx, rep_num,
                      method_list, measure_list):
    """Per method and measure, the repetitions side by side with avg, max
    and min -> ``<lp_res_folder>/<method>_<measure>_record.csv``."""
    if rep_num <= 0:
        return
    reps = range(start_idx, start_idx + rep_num)
    output_base_path = os.path.join(base_path, lp_res_folder)
    check_and_make_path(output_base_path)
    for method in method_list:
        paths = [os.path.join(base_path, f"{lp_res_folder}_{i}",
                              method + "_auc_record.csv") for i in reps]
        for j, m in enumerate(measure_list):
            tables.aggregate_reps(
                paths, 1 + j, [f"{m}_{i}" for i in reps],
                os.path.join(output_base_path, f"{method}_{m}_record.csv"))


def link_prediction(args, device="cuda"):
    """The ``link_pred`` task of a config section.  ``worker`` is accepted
    and not used: the splits are generated file by file."""
    base_path = args["base_path"]
    origin_folder = args["origin_folder"]
    embedding_folder = args["embed_folder"]
    node_file = args["node_file"]
    lp_edge_folder = args["lp_edge_folder"]
    lp_res_folder = args["lp_res_folder"]
    file_sep = args.get("file_sep", "\t")
    start_idx = args.get("start_idx", 0)
    rep_num = args.get("rep_num", 1)
    train_ratio = args["train_ratio"]
    val_ratio = args["val_ratio"]
    test_ratio = args["test_ratio"]
    do_lp = args.get("do_lp", True)
    generate = args.get("generate", True)
    aggregate = args.get("aggregate", False)
    method_list = args.get("method_list", None)
    C_list = args.get("c_list", None)
    measure_list = args.get("measure_list", ["Avg", "Had", "L1", "L2"])
    max_iter = args.get("max_iter", 5000)
    device = resolve_device(device)

    timing = {"generate_seconds": 0.0, "predict_seconds": 0.0}
    if do_lp:
        for i in range(start_idx, start_idx + rep_num):
            data_generator = DataGenerator(
                base_path=base_path, input_folder=origin_folder,
                output_folder=f"{lp_edge_folder}_{i}", node_file=node_file,
                file_sep=file_sep, train_ratio=train_ratio,
                val_ratio=val_ratio, test_ratio=test_ratio, seed=i)
            t0 = time.time()
            if generate:
                data_generator.generate_edge_samples_all_time(sep=file_sep)
            timing["generate_seconds"] += time.time() - t0
            link_predictor = LinkPredictor(
                base_path=base_path, origin_folder=origin_folder,
                embedding_folder=embedding_folder,
                lp_edge_folder=f"{lp_edge_folder}_{i}",
                output_folder=f"{lp_res_folder}_{i}", node_file=node_file,
                file_sep=file_sep, C_list=C_list, measure_list=measure_list,
                max_iter=max_iter, device=device)
            t1 = time.time()
            link_predictor.link_prediction_all_method(method_list=method_list)
            timing["predict_seconds"] += time.time() - t1
            print("link prediction cost time:", time.time() - t1, "seconds!")

    if aggregate:
        aggregate_results(base_path, lp_res_folder, start_idx, rep_num,
                          method_list, measure_list)
    return timing
