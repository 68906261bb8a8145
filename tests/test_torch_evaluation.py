# coding: utf-8
"""The port's evaluators against ``ctgcn_tpu.evaluation`` on the CPU: the
scikit-learn and pandas pieces (``ctgcn_torch.evaluation.linear``), the
negative edge sampler, and link prediction, node and edge classification
end to end through the port's CLI (``--device cpu``) on a small synthetic
dataset: three well-separated communities, so every fit's choice is clear.
Split CSVs must be byte-identical; AUCs agree within 1e-3 and accuracies
exactly."""
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.linear_model import LogisticRegression, Ridge
from sklearn.metrics import accuracy_score, roc_auc_score
from sklearn.model_selection import cross_val_predict
from sklearn.multiclass import OneVsRestClassifier
from sklearn.preprocessing import LabelBinarizer

from ctgcn_torch import main as cli
from ctgcn_torch import utils as tu
from ctgcn_torch.data.formats import write_embedding_csv
from ctgcn_torch.evaluation import linear
from ctgcn_torch.evaluation.node_classification import binarize
from ctgcn_tpu import utils as ju
from ctgcn_tpu.evaluation.edge_classification import edge_classification
from ctgcn_tpu.evaluation.link_prediction import link_prediction
from ctgcn_tpu.evaluation.node_classification import node_classification

N, SNAPS, K, DIM = 81, 4, 3, 8
DATES = [f"2010-0{t + 1}" for t in range(SNAPS)]
METHOD = "CTGCN-C"


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_get_neg_edge_samples_matches_jax(seed):
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.randint(0, 30, 40), rng.randint(0, 30, 40),
                    np.ones(40, np.int64)], 1)
    all_edges = {(int(u), int(v)): 1 for u, v, _ in pos}
    got = tu.get_neg_edge_samples(pos, 40, all_edges, 30,
                                  rng=np.random.RandomState(seed + 10))
    ref = ju.get_neg_edge_samples(pos, 40, all_edges, 30,
                                  rng=np.random.RandomState(seed + 10))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    x = np.linspace(-40, 40, 101)
    np.testing.assert_allclose(tu.sigmoid(torch.from_numpy(x)).numpy(),
                               ju.sigmoid(x), rtol=1e-15, atol=0)


def _binary_problem(n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X @ rng.randn(d) + rng.randn(n) > 0.4).astype(np.int64)
    return X, y


@pytest.mark.parametrize("C", [0.01, 0.1, 1, 10])
def test_fit_logistic_matches_sklearn(C):
    X, y = _binary_problem()
    w = linear.fit_logistic(torch.from_numpy(X), torch.from_numpy(y),
                            [0.5, C], max_iter=100)[1].numpy()
    ref = LogisticRegression(C=C, solver="lbfgs", max_iter=100000, tol=1e-10,
                             class_weight="balanced").fit(X, y)
    np.testing.assert_allclose(w, np.r_[ref.coef_[0], ref.intercept_],
                               rtol=1e-5, atol=1e-5 * np.abs(ref.coef_).max())
    p = linear.predict_logistic(torch.from_numpy(w[None]),
                                torch.from_numpy(X))[0].numpy()
    np.testing.assert_allclose(p, ref.predict_proba(X)[:, 1], atol=1e-6)


@pytest.mark.parametrize("n_class", [2, 3])
def test_ovr_matches_sklearn(n_class):
    rng = np.random.RandomState(n_class)
    centers = 2.0 * rng.randn(n_class, 5)
    labels = rng.randint(0, n_class, 240)
    X = centers[labels] + rng.randn(240, 5)
    lb = LabelBinarizer().fit(np.arange(n_class))
    Y = lb.transform(labels)
    np.testing.assert_array_equal(binarize(labels, np.arange(n_class)), Y)
    np.testing.assert_array_equal(binarize(np.array([0, n_class + 4]),
                                           np.arange(n_class)),
                                  lb.transform(np.array([0, n_class + 4])))
    Cs = [0.1, 1.0]
    models = linear.fit_ovr(torch.from_numpy(X), torch.from_numpy(Y), Cs)
    P = linear.ovr_proba(models, torch.from_numpy(X), len(Cs)).numpy()
    for b, C in enumerate(Cs):
        ref = OneVsRestClassifier(LogisticRegression(
            C=C, solver="lbfgs", max_iter=100000, tol=1e-10,
            class_weight="balanced")).fit(X, Y)
        np.testing.assert_allclose(P[b], ref.predict_proba(X), atol=1e-6)
        np.testing.assert_array_equal(P[b].argmax(1),
                                      ref.predict_proba(X).argmax(1))
    # a class absent from training is a constant predictor
    Y0 = Y.copy()
    if n_class == 3:
        Y0[:, 2] = 0
        models = linear.fit_ovr(torch.from_numpy(X), torch.from_numpy(Y0),
                                Cs)
        assert models[2] == 0
        np.testing.assert_array_equal(
            linear.ovr_proba(models, torch.from_numpy(X), 2)[..., 2], 0.0)


def test_ridge_cross_val_predict_matches_sklearn():
    rng = np.random.RandomState(3)
    X, Y = rng.randn(103, 7), rng.rand(103, 4)
    alphas = [0.05, 1, 10]
    got = linear.ridge_cross_val_predict(torch.from_numpy(X),
                                         torch.from_numpy(Y), alphas, 5)
    for a, alpha in enumerate(alphas):
        for j in range(4):
            ref = cross_val_predict(Ridge(alpha=alpha), X, Y[:, j], cv=5)
            np.testing.assert_allclose(got[a, :, j].numpy(), ref, rtol=1e-9,
                                       atol=1e-12)


def test_auc_spearman_accuracy_match_sklearn_and_pandas():
    rng = np.random.RandomState(4)
    y = rng.randint(0, 2, 500)
    score = np.round(rng.rand(500) + 0.3 * y, 1)          # many ties
    assert abs(linear.roc_auc(torch.from_numpy(y), torch.from_numpy(score))
               - roc_auc_score(y, score)) < 1e-12
    with pytest.raises(ValueError, match="one class"):
        linear.roc_auc(torch.zeros(5), torch.rand(5))
    a = np.round(rng.rand(400), 2)
    b = np.round(a + rng.rand(400), 1)
    b[7] = np.nan
    ref = pd.Series(a).corr(pd.Series(b), method="spearman")
    assert abs(linear.spearman(torch.from_numpy(a), torch.from_numpy(b))
               - ref) < 1e-12
    Yt = rng.randint(0, 2, (60, 3))
    Yp = Yt.copy()
    Yp[::7, 1] ^= 1
    assert linear.accuracy(torch.from_numpy(Yt), torch.from_numpy(Yp)) \
        == accuracy_score(Yt, Yp)


# ---------------------------------------------------------------------------
# the tasks end to end
# ---------------------------------------------------------------------------

def _write(path, header, rows):
    path.write_text(header + "\n" + "".join("\t".join(map(str, r)) + "\n"
                                            for r in rows))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Nodes ``n0..n80`` in three communities (90 % of edges inside one),
    embeddings at well-separated community centers for one method, node
    labels (the community, a few flipped) and edge labels (the community
    of a within-community edge, a few flipped)."""
    base = tmp_path_factory.mktemp("eval_data")
    rng = np.random.RandomState(7)
    names = [f"n{i}" for i in range(N)]
    comm = np.arange(N) % K
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    for d in ("1.format", "nodes_label", "edges_label",
              f"2.embedding/{METHOD}"):
        (base / d).mkdir(parents=True)
    centers = 3.0 * np.eye(K, DIM)
    for date in DATES:
        edges = []
        for _ in range(500):
            u = rng.randint(N)
            v = (rng.choice(np.flatnonzero(comm == comm[u]))
                 if rng.rand() < 0.9 else rng.randint(N))
            edges.append((u, v))
        _write(base / "1.format" / f"{date}.csv", "from_id\tto_id\tweight",
               [(names[u], names[v], 1 + rng.randint(3)) for u, v in edges])
        emb = centers[comm] + 0.3 * rng.randn(N, DIM)
        write_embedding_csv(base / "2.embedding" / METHOD / f"{date}.csv",
                            emb, names)
        lab = comm.copy()
        flip = rng.choice(N, 4, replace=False)
        lab[flip] = (lab[flip] + 1) % K
        _write(base / "nodes_label" / f"{date}.csv", "node\tlabel",
               [(names[i], lab[i]) for i in rng.permutation(N)])
        inside = [(u, v) for u, v in edges if comm[u] == comm[v] and u != v]
        elab = [comm[u] if rng.rand() > 0.05 else (comm[u] + 1) % K
                for u, _ in inside]
        _write(base / "edges_label" / f"{date}.csv", "from_id\tto_id\tlabel",
               [(names[u], names[v], l) for (u, v), l in zip(inside, elab)])
    common = {"base_path": str(base), "origin_folder": "1.format",
              "embed_folder": "2.embedding",
              "node_file": "nodes_set/nodes.csv",
              "file_sep": "\t", "start_idx": 0, "rep_num": 2,
              "generate": True, "aggregate": True, "max_iter": 10000,
              "worker": -1, "method_list": [METHOD, "absent"]}
    config = {
        "link_pred": dict(common, lp_edge_folder="lp_data",
                          lp_res_folder="lp_res", train_ratio=0.5,
                          val_ratio=0.3, test_ratio=0.2, do_lp=True,
                          c_list=[0.01, 0.1, 1, 10],
                          measure_list=["Avg", "Had", "L1", "L2", "sigmoid"]),
        "node_cls": dict(common, nlabel_folder="nodes_label",
                         nodecls_data_folder="nodecls_data",
                         nodecls_res_folder="nodecls_res", train_ratio=0.7,
                         val_ratio=0.2, test_ratio=0.1, do_nodecls=True,
                         c_list=[0.01, 0.1, 1, 10], method_list=[METHOD]),
        "edge_cls": dict(common, elabel_folder="edges_label",
                         edgecls_data_folder="edgecls_data",
                         edgecls_res_folder="edgecls_res", train_ratio=0.7,
                         val_ratio=0.2, test_ratio=0.1, do_edgecls=True,
                         c_list=[0.1, 1, 10], method_list=[METHOD]),
    }
    return base, config


JAX_TASKS = {"link_pred": link_prediction, "node_cls": node_classification,
             "edge_cls": edge_classification}


def _run_both(dataset, tmp_path, task):
    """The JAX task and the port's CLI each on a copy of the dataset."""
    base, config = dataset
    roots = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        shutil.copytree(base, root)
        section = dict(config[task], base_path=str(root))
        if side == "jax":
            JAX_TASKS[task](section)
        else:
            cfg = tmp_path / "cfg.json"
            cfg.write_text(json.dumps({task: section}))
            timing = cli.main([f"--config={cfg}", f"--task={task}",
                               "--device", "cpu"])
            assert set(timing) == {"generate_seconds", "predict_seconds"}
        roots[side] = root
    return roots["jax"], roots["torch"], config[task]


def _same_bytes(a, b):
    files = sorted(os.listdir(a))
    assert files and files == sorted(os.listdir(b))
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_link_pred_matches_jax(dataset, tmp_path):
    jax_root, torch_root, cfg = _run_both(dataset, tmp_path, "link_pred")
    for i in range(2):
        _same_bytes(jax_root / f"lp_data_{i}", torch_root / f"lp_data_{i}")
        for method in cfg["method_list"]:
            ref = pd.read_csv(jax_root / f"lp_res_{i}"
                              / f"{method}_auc_record.csv")
            got = pd.read_csv(torch_root / f"lp_res_{i}"
                              / f"{method}_auc_record.csv")
            assert list(got.columns) == list(ref.columns)
            assert list(got["date"]) == list(ref["date"])
            np.testing.assert_allclose(got.iloc[:, 1:].values.astype(float),
                                       ref.iloc[:, 1:].values.astype(float),
                                       atol=1e-3)
        assert len(ref) == 0                    # "absent": no embeddings
    rec = pd.read_csv(torch_root / "lp_res_0" / f"{METHOD}_auc_record.csv")
    assert list(rec["date"]) == DATES[1:]       # t >= 1, embedding of t - 1
    assert rec["Had"].min() > 0.8
    for method in cfg["method_list"]:
        for m in cfg["measure_list"]:
            name = f"{method}_{m}_record.csv"
            ref = pd.read_csv(jax_root / "lp_res" / name)
            got = pd.read_csv(torch_root / "lp_res" / name)
            assert list(got.columns) == list(ref.columns) == [
                "date", f"{m}_0", f"{m}_1", "avg", "max", "min"]
            assert list(got["date"]) == list(ref["date"])
            np.testing.assert_allclose(got.iloc[:, 1:].values.astype(float),
                                       ref.iloc[:, 1:].values.astype(float),
                                       atol=1e-3)


@pytest.mark.parametrize("task, data, res", [
    ("node_cls", "nodecls_data", "nodecls_res"),
    ("edge_cls", "edgecls_data", "edgecls_res"),
])
def test_classification_matches_jax(dataset, tmp_path, task, data, res):
    jax_root, torch_root, _ = _run_both(dataset, tmp_path, task)
    for i in range(2):
        _same_bytes(jax_root / f"{data}_{i}", torch_root / f"{data}_{i}")
    for folder in (f"{res}_0", f"{res}_1", res):
        ref = pd.read_csv(jax_root / folder / f"{METHOD}_acc_record.csv")
        got = pd.read_csv(torch_root / folder / f"{METHOD}_acc_record.csv")
        assert list(got.columns) == list(ref.columns)
        assert list(got["date"]) == list(ref["date"]) == DATES
        np.testing.assert_array_equal(got.iloc[:, 1:].values,
                                      ref.iloc[:, 1:].values)
    acc = pd.read_csv(torch_root / res / f"{METHOD}_acc_record.csv")["avg"]
    assert 0.7 < acc.min() and acc.max() < 1.0   # the flipped labels miss


def test_every_task_runs_on_the_cpu_without_not_implemented(dataset,
                                                            tmp_path):
    """Each evaluation task dispatches from the CLI; without a GPU the
    default device stops the run."""
    base, config = dataset
    root = tmp_path / "d"
    shutil.copytree(base, root)
    sections = {t: dict(config[t], base_path=str(root), rep_num=1,
                        aggregate=False, method_list=[METHOD])
                for t in config}
    sections["cent_pred"] = dict(
        base_path=str(root), origin_folder="1.format",
        embed_folder="2.embedding", node_file="nodes_set/nodes.csv",
        centrality_data_folder="centrality_data",
        centrality_res_folder="centrality_res", method_list=[METHOD],
        alpha_list=[0.5, 2], split_fold=5)
    sections["sim_pred"] = dict(
        base_path=str(root), origin_folder="1.format",
        embed_folder="2.embedding", node_file="nodes_set/nodes.csv",
        similarity_data_folder="similarity_data",
        similarity_res_folder="similarity_res", method_list=[METHOD])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(sections))
    records = {"link_pred": "lp_res_0/CTGCN-C_auc_record.csv",
               "node_cls": "nodecls_res_0/CTGCN-C_acc_record.csv",
               "edge_cls": "edgecls_res_0/CTGCN-C_acc_record.csv",
               "cent_pred": "centrality_res/CTGCN-C_mse_record.csv",
               "sim_pred": "similarity_res/CTGCN-C_mse_record.csv"}
    assert set(records) == set(cli.EVAL_TASKS)
    for task, record in records.items():
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="--device cpu"):
                cli.main([f"--config={cfg}", f"--task={task}"])
        cli.main([f"--config={cfg}", f"--task={task}", "--device=cpu"])
        rec = pd.read_csv(root / record)
        assert len(rec) >= SNAPS - 1
        assert np.isfinite(rec.iloc[:, 1:].values.astype(float)).all()
