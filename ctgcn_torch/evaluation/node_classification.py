# coding: utf-8
"""Node classification (port of
``ctgcn_tpu/evaluation/node_classification.py``), and the machinery it
shares with edge classification.

Per repetition: label splits of every label file (one ``rng.permutation``
of a (rep, file) ``RandomState``, as in the JAX package, so the split CSVs
are byte-identical), then per snapshot with an embedding a one-vs-rest
balanced logistic regression over the C list on the CURRENT snapshot's
embedding, the last C reaching the best validation accuracy kept, and its
test accuracy -> ``<method>_acc_record.csv``.

As in the JAX package, predicted classes are ``argmax`` of the class
scores fed back through the label binarizer, so a class's index stands in
for its label; that is right only for labels 0..k-1.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ctgcn_torch.data.formats import infer_names, sorted_dir
from ctgcn_torch.evaluation import linear, tables
from ctgcn_torch.evaluation.link_prediction import rep_rng
from ctgcn_torch.utils import check_and_make_path, resolve_device

NODE_COLUMNS = ("node", "label")


def binarize(labels, classes):
    """``LabelBinarizer.transform``: indicator rows [n, k] over the sorted
    ``classes``, one column for two classes (the second class), zeros for
    a label it does not know."""
    Y = (np.asarray(labels)[:, None] == np.asarray(classes)[None, :])
    if len(classes) == 2:
        Y = Y[:, 1:]
    elif len(classes) == 1:
        Y = np.zeros((len(labels), 1), bool)
    return Y.astype(np.int64)


class LabelSplitGenerator:
    """Train/val/test splits of labelled nodes or edges: the id columns
    (all but the last, ``columns``) are mapped to node indices."""

    def __init__(self, base_path, output_folder, node_file, label_folder,
                 columns, file_sep="\t", train_ratio=0.7, val_ratio=0.2,
                 test_ratio=0.1, seed=None):
        self.output_base_path = os.path.abspath(
            os.path.join(base_path, output_folder))
        self.label_base_path = os.path.abspath(
            os.path.join(base_path, label_folder))
        self.columns = list(columns)
        self.file_sep = file_sep
        _, self.node2idx_dict = tables.read_nodes(base_path, node_file)
        if train_ratio + test_ratio + val_ratio > 1.0:
            raise ValueError("train + val + test ratios exceed 1")
        self.train_ratio = train_ratio
        self.val_ratio = val_ratio
        self.test_ratio = test_ratio
        self.seed = seed
        check_and_make_path(self.output_base_path)

    def generate_samples(self, file_name, sep="\t"):
        rng = rep_rng(self.seed, file_name)
        date = file_name.split(".")[0]
        with open(os.path.join(self.label_base_path, file_name)) as fp:
            rows = [line.split(sep) for line in fp.read().splitlines()[1:]
                    if line != ""]
        cols = [np.array([self.node2idx_dict[v]
                          for v in infer_names([r[j] for r in rows])],
                         np.int64)
                for j in range(len(self.columns) - 1)]
        cols.append(np.asarray(tables.parse_column([r[-1] for r in rows])))
        n = len(rows)
        order = rng.permutation(n)
        tr = int(np.floor(n * self.train_ratio))
        va = int(np.floor(n * self.val_ratio))
        te = int(np.floor(n * self.test_ratio))
        segs = {"train": order[:tr], "val": order[tr:tr + va],
                "test": order[tr + va:tr + va + te]}
        for name, idx in segs.items():
            tables.write_table(
                os.path.join(self.output_base_path, f"{date}_{name}.csv"),
                self.columns, [c[idx] for c in cols], self.file_sep)

    def generate_all_time(self, sep="\t"):
        """Every label file's splits, one after another."""
        print("Start generating label samples!")
        for f in sorted_dir(self.label_base_path):
            self.generate_samples(f, sep)
        print("Generate label samples finish!")


class Classifier:
    """The C sweep of one-vs-rest logistic regressions on features of the
    split's id columns (``features(ids, embeddings)``)."""

    def __init__(self, base_path, origin_folder, embedding_folder,
                 split_folder, output_folder, node_file, label_folder,
                 features, file_sep="\t", C_list=None, max_iter=5000,
                 device="cuda"):
        self.origin_base_path = os.path.abspath(
            os.path.join(base_path, origin_folder))
        self.embedding_base_path = os.path.abspath(
            os.path.join(base_path, embedding_folder))
        self.split_base_path = os.path.abspath(
            os.path.join(base_path, split_folder))
        self.output_base_path = os.path.abspath(
            os.path.join(base_path, output_folder))
        self.features = features
        self.file_sep = file_sep
        self.full_node_list, _ = tables.read_nodes(base_path, node_file)
        label_base_path = os.path.abspath(
            os.path.join(base_path, label_folder))
        f_list = os.listdir(label_base_path)
        if not f_list:
            raise ValueError(f"no label files under {label_base_path}")
        # the classes of the first file listed, as in the JAX package
        _, cols = tables.read_table(os.path.join(label_base_path, f_list[0]),
                                    file_sep)
        self.classes = np.unique(np.asarray(cols[-1]))
        self.C_list = C_list or [0.01, 0.1, 1, 10]
        self.max_iter = max_iter
        self.device = resolve_device(device)
        check_and_make_path(self.output_base_path)

    def _split(self, date, kind, embeddings):
        cols = tables.read_split(
            os.path.join(self.split_base_path, f"{date}_{kind}.csv"),
            self.file_sep)
        ids = torch.from_numpy(np.stack(cols[:-1], 1)).to(self.device)
        Y = torch.from_numpy(binarize(cols[-1], self.classes)).to(self.device)
        return self.features(ids, embeddings), Y

    def _predict(self, models, X):
        """Indicator rows [B, n, k] of the predicted classes, one per C."""
        idx = linear.ovr_proba(models, X, len(self.C_list)).argmax(-1)
        return torch.from_numpy(
            np.stack([binarize(i, self.classes) for i in idx.cpu().numpy()])
        ).to(self.device)

    def classify_date(self, date, embeddings):
        """Test accuracy of the C with the best validation accuracy."""
        X, Y = self._split(date, "train", embeddings)
        models = linear.fit_ovr(X, Y, self.C_list, self.max_iter)
        X, Y = self._split(date, "val", embeddings)
        val_pred = self._predict(models, X)
        best_acc, best = -1.0, None
        for b in range(len(self.C_list)):
            acc = linear.accuracy(Y, val_pred[b])
            if acc >= best_acc:
                best_acc, best = acc, b
        X, Y = self._split(date, "test", embeddings)
        return linear.accuracy(Y, self._predict(models, X)[best])

    def classification_all_time(self, method):
        print("method =", method)
        all_acc_list = []
        for f_name in sorted_dir(self.origin_base_path):
            date = f_name.split(".")[0]
            cur_embedding_path = os.path.join(self.embedding_base_path,
                                              method, f_name)
            if not os.path.exists(cur_embedding_path):
                continue
            embeddings = torch.from_numpy(tables.read_embedding(
                cur_embedding_path, self.full_node_list,
                self.file_sep)).to(self.device)
            all_acc_list.append([date, self.classify_date(date, embeddings)])
        accs = [a for _, a in all_acc_list]
        print(f"method = {method}, average accuracy: "
              f"{np.mean(accs) if accs else float('nan')}")
        tables.write_record(
            os.path.join(self.output_base_path, method + "_acc_record.csv"),
            ["date", "acc"], all_acc_list)

    def classification_all_method(self, method_list=None):
        if method_list is None:
            method_list = os.listdir(self.embedding_base_path)
        for method in method_list:
            self.classification_all_time(method)


def aggregate_results(base_path, res_folder, start_idx, rep_num,
                      method_list):
    """Per method, the repetitions' accuracies side by side with avg, max
    and min -> ``<res_folder>/<method>_acc_record.csv``."""
    if rep_num <= 0:
        return
    reps = range(start_idx, start_idx + rep_num)
    output_base_path = os.path.join(base_path, res_folder)
    check_and_make_path(output_base_path)
    for method in method_list:
        tables.aggregate_reps(
            [os.path.join(base_path, f"{res_folder}_{i}",
                          method + "_acc_record.csv") for i in reps],
            1, [f"acc_{i}" for i in reps],
            os.path.join(output_base_path, method + "_acc_record.csv"))


def run_classification(args, device, label_key, data_key, res_key, do_key,
                       columns, features):
    """A classification task of a config section (node or edge): splits
    and classifiers per repetition, then the aggregate if asked.  Returns
    the seconds of the split generation and of the fits."""
    base_path = args["base_path"]
    label_folder = args[label_key]
    data_folder = args[data_key]
    res_folder = args[res_key]
    file_sep = args.get("file_sep", "\t")
    start_idx = args.get("start_idx", 0)
    rep_num = args.get("rep_num", 1)
    device = resolve_device(device)
    timing = {"generate_seconds": 0.0, "predict_seconds": 0.0}
    if args.get(do_key, True):
        for i in range(start_idx, start_idx + rep_num):
            print("idx =", i)
            t0 = time.time()
            if args.get("generate", True):
                LabelSplitGenerator(
                    base_path, f"{data_folder}_{i}", args["node_file"],
                    label_folder, columns, file_sep=file_sep,
                    train_ratio=args["train_ratio"],
                    val_ratio=args["val_ratio"],
                    test_ratio=args["test_ratio"],
                    seed=i).generate_all_time(sep=file_sep)
            t1 = time.time()
            Classifier(
                base_path, args["origin_folder"], args["embed_folder"],
                f"{data_folder}_{i}", f"{res_folder}_{i}", args["node_file"],
                label_folder, features, file_sep=file_sep,
                C_list=args.get("c_list", None),
                max_iter=args.get("max_iter", 5000),
                device=device).classification_all_method(
                    args.get("method_list", None))
            timing["generate_seconds"] += t1 - t0
            timing["predict_seconds"] += time.time() - t1
    print("classification cost time:", sum(timing.values()), "seconds!")
    if args.get("aggregate", False):
        aggregate_results(base_path, res_folder, start_idx, rep_num,
                          args.get("method_list", None))
    return timing


def node_features(ids, embeddings):
    return embeddings[ids[:, 0]]


def node_classification(args, device="cuda"):
    """The ``node_cls`` task of a config section.  ``worker`` is accepted
    and not used: the splits are generated file by file."""
    return run_classification(args, device, "nlabel_folder",
                              "nodecls_data_folder", "nodecls_res_folder",
                              "do_nodecls", NODE_COLUMNS, node_features)
