# coding: utf-8
"""The port's host artifacts against ``ctgcn_tpu``: the native host-graph
kernels (``ctgcn_torch.native``, built with g++ into the port's own build
directory) and the embedding CSV bytes.

  * core numbers equal to ``ctgcn_tpu.native.core_numbers`` and to the
    port's numpy peel (exact);
  * walks bit-equal to ``ctgcn_tpu.native.simulate_walks`` for the same
    seed, weighted and unweighted, on an edgeless snapshot, and with one
    thread against several (exact);
  * the preprocessing task's walk artifacts come from the native walks of
    each snapshot's derived seed;
  * ``write_embedding_csv`` writes the bytes of the JAX package's
    ``BaseEmbedding.save_embedding`` (pandas ``to_csv``) for the same
    float32 array.
Mirrors ``tests/unit/test_native.py``.
"""
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

from ctgcn_torch import native as tn
from ctgcn_torch.data import formats as tf
from ctgcn_torch.native import build as tb
from ctgcn_torch.preprocessing import kcore as tk
from ctgcn_torch.preprocessing import walks as tw
from ctgcn_tpu import native as jn
from ctgcn_tpu.training.engine import BaseEmbedding


def _graph(n, density, seed, weighted=True, isolate=()):
    """A symmetric self-loop-free scipy CSR."""
    rng = np.random.default_rng(seed)
    upper = np.triu((rng.random((n, n)) < density)
                    * (rng.random((n, n)) * 3 + 0.1 if weighted else 1.0), 1)
    a = upper + upper.T
    a[list(isolate), :] = 0
    a[:, list(isolate)] = 0
    return sp.csr_matrix(a)


@pytest.fixture(scope="module")
def jax_native():
    if not jn.available():
        pytest.skip("the JAX package's native library did not build")
    return jn


@pytest.mark.parametrize("n, density, seed", [(200, 0.04, 0), (500, 0.02, 1),
                                              (300, 0.007, 2)])
def test_core_numbers_equal_jax_and_numpy_peel(jax_native, n, density, seed):
    adj = _graph(n, density, seed, isolate=(0, 7))
    got = tk.core_numbers(adj)
    np.testing.assert_array_equal(got, jax_native.core_numbers(
        adj.astype(bool).astype(np.int8)))
    np.testing.assert_array_equal(got, tk.peel_core_numbers(adj))
    assert got[0] == got[7] == 0 and got.max() >= 2


def test_core_numbers_of_an_empty_graph():
    assert not tn.core_numbers(sp.csr_matrix((10, 10))).any()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("seed", [0, 2**63 + 5])
def test_walks_bit_equal_jax(jax_native, weighted, seed):
    adj = _graph(150, 0.04, 3, isolate=(0,))
    got = tn.simulate_walks(adj, 4, 6, seed, weighted=weighted)
    ref = jax_native.simulate_walks(adj, 4, 6, weighted=weighted, seed=seed)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (150 * 6, 5)
    np.testing.assert_array_equal(got[:, 0], np.repeat(np.arange(150), 6))
    assert (got[:6] == 0).all()                  # the isolated node stays
    for u, v in zip(got[:, :-1].ravel(), got[:, 1:].ravel()):
        assert u == v and adj.indptr[u] == adj.indptr[u + 1] or adj[u, v]


def test_walks_edgeless_snapshot(jax_native):
    empty = sp.csr_matrix((7, 7))
    got = tn.simulate_walks(empty, 3, 2, 5, weighted=True)
    np.testing.assert_array_equal(
        got, jax_native.simulate_walks(empty, 3, 2, weighted=True, seed=5))
    np.testing.assert_array_equal(
        got, np.repeat(np.repeat(np.arange(7), 2)[:, None], 4, axis=1))


def test_walks_do_not_depend_on_the_thread_count(jax_native):
    adj = _graph(400, 0.02, 4)
    one = tn.simulate_walks(adj, 5, 8, 11, n_threads=1)
    for nt in (2, 4, 0):
        np.testing.assert_array_equal(
            one, tn.simulate_walks(adj, 5, 8, 11, n_threads=nt))
    np.testing.assert_array_equal(
        one, jax_native.simulate_walks(adj, 5, 8, seed=11, n_threads=3))
    assert not np.array_equal(one, tn.simulate_walks(adj, 5, 8, 12))


def test_walk_weight_bias():
    """A 10x heavier edge is taken about 10x as often (inverse CDF)."""
    adj = sp.csr_matrix(([10.0, 1.0, 10.0, 1.0], ([0, 0, 1, 2], [1, 2, 0, 0])),
                        shape=(3, 3))
    first = tn.simulate_walks(adj, 1, 20000, 1)[:20000, 1]
    assert abs((first == 1).mean() - 10 / 11) < 0.02
    first = tn.simulate_walks(adj, 1, 20000, 1, weighted=False)[:20000, 1]
    assert abs((first == 1).mean() - 0.5) < 0.02


def test_simulate_walks_routing():
    """No ``rng``: the native walks of ``seed``; a numpy ``rng``: the
    numpy sampler."""
    adj = _graph(60, 0.06, 5)
    np.testing.assert_array_equal(tw.simulate_walks(adj, 3, 2, seed=9),
                                  tn.simulate_walks(adj, 3, 2, 9))
    got = tw.simulate_walks(adj, 3, 2, np.random.RandomState(0))
    assert got.shape == (120, 4)


def test_threads_default(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert tn.default_threads() == 3
    monkeypatch.delenv("OMP_NUM_THREADS")
    assert tn.default_threads() == 0


def test_library_lives_in_the_port_build_dir_and_build_failure_raises(
        monkeypatch, tmp_path):
    path = tb.build()
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "ctgcn_torch" and path.name.startswith("libhostgraph_")
    assert str(path) == str(tn.load()._name)
    monkeypatch.setattr(tb, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tb.build(compiler="no-such-compiler")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tb, "SRC", bad)
    with pytest.raises(RuntimeError, match="failed"):
        tb.build()
    assert os.listdir(tmp_path) == ["bad.cpp"]


def test_preprocessing_walks_come_from_the_snapshot_seeds(jax_native,
                                                        tmp_path):
    from ctgcn_torch.preprocessing import preprocess

    rng = np.random.default_rng(6)
    (tmp_path / "nodes_set").mkdir()
    (tmp_path / "nodes_set" / "nodes.csv").write_text(
        "".join(f"n{i}\n" for i in range(40)))
    (tmp_path / "1.format").mkdir()
    for t in range(2):
        (tmp_path / "1.format" / f"d{t}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"n{a}\tn{b}\t{w}\n" for a, b, w in zip(
                    rng.integers(0, 40, 90), rng.integers(0, 40, 90),
                    rng.integers(1, 4, 90))))
    preprocess("CTGCN-C", {
        "base_path": str(tmp_path), "origin_folder": "1.format",
        "core_folder": None, "node_file": "nodes_set/nodes.csv",
        "walk_pair_folder": "walks", "node_freq_folder": "freq",
        "walk_time": 3, "walk_length": 4, "seed": 2})
    names = tf.read_node_list(str(tmp_path / "nodes_set" / "nodes.csv"))
    seeds = [tw.snapshot_seed(2, t) for t in range(2)]
    assert len(set(seeds)) == 2 and all(0 <= s < 2**64 for s in seeds)
    for t in range(2):
        adj = tf.get_sp_adj_mat(str(tmp_path / "1.format" / f"d{t}.csv"),
                                names)
        walks = jax_native.simulate_walks(adj.tocsr(), 4, 3, seed=seeds[t])
        pairs, freq = tw.walk_pairs_and_freq(walks, 40)
        got = sp.load_npz(tmp_path / "walks" / f"d{t}.npz").tocsr()
        assert (got != pairs.tocsr()).nnz == 0
        with open(tmp_path / "freq" / f"d{t}.json") as fp:
            assert json.load(fp) == tw.negative_sampling_list(freq)


def test_embedding_csv_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    arr = (rng.standard_normal((40, 9))
           * 10.0 ** rng.integers(-11, 12, (40, 9))).astype(np.float32)
    arr[0, :9] = [0.0, -0.0, 1e-05, 1e+16, 1.7640524, np.float32(1e-45),
                  np.float32(-3e-39), 1e-4, 123456790.0]
    arr[1, :3] = [np.finfo(np.float32).max, np.finfo(np.float32).tiny, 0.1]
    names = [f"u{i}" for i in range(40)]
    (tmp_path / "origin").mkdir()
    (tmp_path / "origin" / "2001.csv").write_text("")
    BaseEmbedding(str(tmp_path), "origin", "jax", names, None).save_embedding(
        arr[None], 0)
    tf.write_embedding_csv(tmp_path / "port.csv", arr, names)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax" / "2001.csv").read_bytes())
    # integer node names are written as pandas writes them, too
    BaseEmbedding(str(tmp_path), "origin", "jax_int", list(range(40)),
                  None).save_embedding(arr[None], 0)
    tf.write_embedding_csv(tmp_path / "port_int.csv", arr, list(range(40)))
    assert ((tmp_path / "port_int.csv").read_bytes()
            == (tmp_path / "jax_int" / "2001.csv").read_bytes())
    names_back, back = tf.read_embedding_csv(tmp_path / "port.csv")
    assert names_back == names
    np.testing.assert_array_equal(back.view(np.uint32), arr.view(np.uint32))


def test_embedding_csvs_from_workers_equal_the_writer(tmp_path,
                                                      monkeypatch):
    """``write_embedding_csvs`` in worker processes, several tasks per
    array, writes the bytes ``write_embedding_csv`` writes."""
    rng = np.random.default_rng(8)
    arrays = [(rng.standard_normal((40, 9))
               * 10.0 ** rng.integers(-11, 12, (40, 9))).astype(np.float32)
              for _ in range(3)]
    names = [f"u{i}" for i in range(40)]
    for t, arr in enumerate(arrays):
        tf.write_embedding_csv(tmp_path / f"ref{t}.csv", arr, names)
    monkeypatch.setattr(tf, "PARALLEL_MIN_ROWS", 0)
    monkeypatch.setattr(tf, "CHUNK_ROWS", 16)
    tf.write_embedding_csvs([tmp_path / f"par{t}.csv" for t in range(3)],
                            arrays, names)
    for t in range(3):
        assert ((tmp_path / f"par{t}.csv").read_bytes()
                == (tmp_path / f"ref{t}.csv").read_bytes())
