# coding: utf-8
"""The port's centralities against networkx, and the ``cent_pred`` and
``sim_pred`` tasks against ``ctgcn_tpu.evaluation`` end to end (the port
through its CLI, ``--device cpu``), within 1e-9."""
import json
import shutil
from pathlib import Path

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg

from ctgcn_torch import main as cli
from ctgcn_torch.data.formats import (get_sp_adj_mat, read_node_list,
                                      write_embedding_csv)
from ctgcn_torch.evaluation import centrality as C
from ctgcn_tpu.evaluation.centrality_prediction import centrality_prediction
from ctgcn_tpu.evaluation.similarity_prediction import similarity_prediction

UCI = Path(__file__).resolve().parent.parent / "data" / "uci"
TOL = 1e-9


def _components():
    """Two components with weights, a self-loop and isolated nodes."""
    rng = np.random.RandomState(0)
    d = np.zeros((30, 30))
    for lo, hi, p in ((0, 12, 0.3), (12, 25, 0.25)):
        for i in range(lo, hi):
            for j in range(i + 1, hi):
                if rng.rand() < p:
                    d[i, j] = d[j, i] = 0.5 + rng.rand()
    d[3, 3] = 1.0
    return sp.coo_matrix(d)


def _tree():
    return nx.to_scipy_sparse_array(nx.random_labeled_tree(40, seed=1),
                                    nodelist=range(40))


def _uci():
    nodes = read_node_list(UCI / "nodes_set" / "nodes.csv")
    return get_sp_adj_mat(UCI / "1.format" / "2004-10.csv", nodes)


@pytest.mark.parametrize("graph", [_components, _tree, _uci],
                         ids=["components", "tree", "uci-2004-10"])
def test_centralities_match_networkx(graph):
    adj = graph()
    g = nx.from_scipy_sparse_array(adj)
    n = adj.shape[0]
    A = C.edge_pattern(adj, "cpu")
    closeness, betweenness = C.shortest_path_centralities(A)
    refs = {"closeness": nx.closeness_centrality(g),
            "betweenness": nx.betweenness_centrality(g),
            "eigenvector": nx.eigenvector_centrality(g, max_iter=1000)}
    got = {"closeness": closeness, "betweenness": betweenness,
           "eigenvector": C.eigenvector_centrality(A)}
    for name, ref in refs.items():
        np.testing.assert_allclose(got[name].numpy(),
                                   [ref[i] for i in range(n)], rtol=TOL,
                                   atol=TOL, err_msg=name)
    # sources in batches of 7 give the same values as one batch
    for a, b in zip(C.shortest_path_centralities(A, state_bytes=64 * n * 7),
                    (closeness, betweenness)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three snapshots of a 60-node weighted graph with isolated nodes, and
    seeded embeddings of one method.  A pair's weight depends on the pair
    only: with two weights for one pair, the adjacency both packages read
    is not symmetric and ARPACK's lambda_1 varies from call to call."""
    base = tmp_path_factory.mktemp("cent_data")
    rng = np.random.RandomState(5)
    names = [f"v{i}" for i in range(60)]
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    (base / "1.format").mkdir()
    (base / "2.embedding" / "CTGCN-C").mkdir(parents=True)
    for t in range(3):
        src = rng.randint(0, 50, 90)
        dst = rng.randint(0, 50 - 10 * t, 90)
        (base / "1.format" / f"{t}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"{names[a]}\t{names[b]}\t{1 + (a * b) % 3}\n"
                for a, b in zip(src, dst)))
        write_embedding_csv(base / "2.embedding" / "CTGCN-C" / f"{t}.csv",
                            rng.randn(60, 6), names)
    common = {"base_path": str(base), "origin_folder": "1.format",
              "embed_folder": "2.embedding",
              "node_file": "nodes_set/nodes.csv",
              "file_sep": "\t", "generate": True, "method_list": ["CTGCN-C"],
              "worker": -1}
    return base, {
        "cent_pred": dict(common, centrality_data_folder="centrality_data",
                          centrality_res_folder="centrality_res",
                          alpha_list=[0.05, 0.5, 1, 2, 5, 10], split_fold=5),
        "sim_pred": dict(common, similarity_data_folder="similarity_data",
                         similarity_res_folder="similarity_res", alpha=0.5,
                         iter_num=100)}


def _run_both(dataset, tmp_path, task, jax_task):
    base, config = dataset
    roots = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        shutil.copytree(base, root)
        section = dict(config[task], base_path=str(root))
        if side == "jax":
            with pytest.MonkeyPatch.context() as mp:
                # the port's fixed ARPACK start (the JAX package leaves it
                # random, so its lambda_1 moves by an ulp from call to call)
                eigsh = scipy.sparse.linalg.eigsh
                mp.setattr(scipy.sparse.linalg, "eigsh",
                           lambda A, **kw: eigsh(
                               A, v0=np.ones(A.shape[0]), **kw))
                jax_task(section)
        else:
            cfg = tmp_path / "cfg.json"
            cfg.write_text(json.dumps({task: section}))
            cli.main([f"--config={cfg}", f"--task={task}", "--device=cpu"])
        roots[side] = root
    return roots["jax"], roots["torch"]


def _same_record(a, b):
    ref, got = pd.read_csv(a), pd.read_csv(b)
    assert list(got.columns) == list(ref.columns)
    assert list(got.iloc[:, 0]) == list(ref.iloc[:, 0])
    assert len(got) == 3
    np.testing.assert_allclose(got.iloc[:, 1:].values.astype(float),
                               ref.iloc[:, 1:].values.astype(float),
                               rtol=TOL, atol=TOL)


def test_cent_pred_matches_jax(dataset, tmp_path):
    jax_root, torch_root = _run_both(dataset, tmp_path, "cent_pred",
                                     centrality_prediction)
    for t in range(3):
        ref = pd.read_csv(jax_root / "centrality_data" / f"{t}_centrality.csv",
                          sep="\t")
        got = pd.read_csv(torch_root / "centrality_data"
                          / f"{t}_centrality.csv", sep="\t")
        assert list(got.columns) == list(ref.columns)
        assert list(got.dtypes) == list(ref.dtypes)
        np.testing.assert_array_equal(got[["node", "kcore"]].values,
                                      ref[["node", "kcore"]].values)
        np.testing.assert_allclose(got.values, ref.values, rtol=TOL,
                                   atol=TOL)
    _same_record(jax_root / "centrality_res" / "CTGCN-C_mse_record.csv",
                 torch_root / "centrality_res" / "CTGCN-C_mse_record.csv")


def test_sim_pred_matches_jax(dataset, tmp_path):
    """With the same lambda_1 the matrices are the same doubles (the
    products are summed in scipy's order), so the Spearman records, which
    hang on which entries tie, agree; the port's predictor also scores the
    JAX package's matrices as the JAX package does."""
    jax_root, torch_root = _run_both(dataset, tmp_path, "sim_pred",
                                     similarity_prediction)
    for t in range(3):
        ref = sp.load_npz(jax_root / "similarity_data"
                          / f"{t}_similarity.npz").toarray()
        got = sp.load_npz(torch_root / "similarity_data"
                          / f"{t}_similarity.npz").toarray()
        np.testing.assert_array_equal(got, ref)
    record = Path("similarity_res") / "CTGCN-C_mse_record.csv"
    _same_record(jax_root / record, torch_root / record)
    # the port's predictor on the JAX package's matrices
    shutil.rmtree(torch_root / "similarity_res")
    shutil.rmtree(torch_root / "similarity_data")
    shutil.copytree(jax_root / "similarity_data",
                    torch_root / "similarity_data")
    cfg = tmp_path / "cfg.json"
    section = dict(dataset[1]["sim_pred"], base_path=str(torch_root),
                   generate=False)
    cfg.write_text(json.dumps({"sim_pred": section}))
    cli.main([f"--config={cfg}", "--task=sim_pred", "--device=cpu"])
    _same_record(jax_root / record, torch_root / record)
