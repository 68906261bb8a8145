# coding: utf-8
"""Host-side port against ``ctgcn_tpu``: graph file IO, k-core pyramids,
random walks, and the window loaders, on the bundled UCI snapshots and on
generated artifacts.  All arrays must be identical (integer data and f32
values copied, never recomputed)."""
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.data import formats as tf
from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.preprocessing import kcore as tk
from ctgcn_torch.preprocessing import walks as tw
from ctgcn_tpu.data import formats as jf
from ctgcn_tpu import native as jn
from ctgcn_tpu.data.loader import DataLoader as JDataLoader
from ctgcn_tpu.preprocessing import kcore as jk
from ctgcn_tpu.preprocessing import walks as jw

UCI = Path(__file__).resolve().parent.parent / "data" / "uci"
SNAPSHOTS = sorted(os.listdir(UCI / "1.format"))


@pytest.fixture(scope="module")
def nodes():
    path = str(UCI / "nodes_set" / "nodes.csv")
    got = tf.read_node_list(path)
    assert got == jf.read_node_list(path)
    return got


def _same_sparse(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sum_duplicates()
    b.sum_duplicates()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("snap", SNAPSHOTS)
def test_formats_and_kcore_match_on_uci(snap, nodes, tmp_path):
    """Edge arrays, adjacency, core numbers and every k-core .npz."""
    path = str(UCI / "1.format" / snap)
    node2idx = dict(zip(nodes, range(len(nodes))))
    for got, ref in zip(tf.read_edge_csv(path, node2idx),
                        jf.read_edge_csv(path, node2idx)):
        np.testing.assert_array_equal(got, ref)
    adj_t = tf.get_sp_adj_mat(path, nodes)
    _same_sparse(adj_t, jf.get_sp_adj_mat(path, nodes))
    np.testing.assert_array_equal(tk.core_numbers(adj_t),
                                  jk.core_numbers(adj_t))

    gen_t = tk.StructureInfoGenerator(str(UCI), "1.format",
                                      str(tmp_path / "t"), "nodes_set/nodes.csv")
    gen_j = jk.StructureInfoGenerator(str(UCI), "1.format",
                                      str(tmp_path / "j"), "nodes_set/nodes.csv")
    gen_t.get_kcore_graph(snap, str(tmp_path / "t" / "d"))
    gen_j.get_kcore_graph(snap, str(tmp_path / "j" / "d"))
    files = sorted(os.listdir(tmp_path / "j" / "d"))
    assert files and sorted(os.listdir(tmp_path / "t" / "d")) == files
    for f in files:
        _same_sparse(sp.load_npz(tmp_path / "t" / "d" / f),
                     sp.load_npz(tmp_path / "j" / "d" / f))


@pytest.mark.parametrize("rows, ab, ba", [
    # a repeated (u, v) keeps its last row's weight, in both directions
    ("a\tb\t1\nb\tc\t2\nc\tc\t9\na\tb\t7\n", 7, 7),
    # the reversed copies of all rows come after the rows as given, so the
    # last (v, u) row sets (u, v) and the last (u, v) row sets (v, u)
    ("a\tb\t1\nb\tc\t2\nb\ta\t5\nc\tc\t9\na\tb\t7\n", 5, 7),
])
def test_duplicate_edges_last_write_wins(tmp_path, rows, ab, ba):
    path = tmp_path / "e.csv"
    path.write_text("from_id\tto_id\tweight\n" + rows)
    names = ["a", "b", "c"]
    got = tf.get_sp_adj_mat(str(path), names).toarray()
    _same_sparse(sp.coo_matrix(got), jf.get_sp_adj_mat(str(path), names))
    assert (got[0, 1], got[1, 0], got[2, 2]) == (ab, ba, 0)


def test_integer_node_names(tmp_path):
    """Numeric node names read as ints, as pandas infers them."""
    (tmp_path / "n.csv").write_text("3\n10\n7\n")
    (tmp_path / "e.csv").write_text("from_id\tto_id\n3\t10\n7\t3\n")
    names = tf.read_node_list(str(tmp_path / "n.csv"))
    assert names == jf.read_node_list(str(tmp_path / "n.csv")) == [3, 10, 7]
    _same_sparse(tf.get_sp_adj_mat(str(tmp_path / "e.csv"), names),
                 jf.get_sp_adj_mat(str(tmp_path / "e.csv"), names))


@pytest.mark.parametrize("weighted", [True, False])
def test_walks_match_under_same_random_state(weighted, nodes):
    """Walks, co-occurrence pairs, frequencies and the negative-sampling
    list are identical under the same numpy RandomState."""
    adj = tf.get_sp_adj_mat(str(UCI / "1.format" / SNAPSHOTS[1]), nodes)
    got = tw.simulate_walks(adj, 5, 3, np.random.RandomState(7),
                            weighted=weighted)
    ref = jw.simulate_walks(adj, 5, 3, weighted=weighted,
                            rng=np.random.RandomState(7))
    np.testing.assert_array_equal(got, ref)
    pairs_t, freq_t = tw.walk_pairs_and_freq(got, adj.shape[0])
    pairs_j, freq_j = jw.walk_pairs_and_freq(ref, adj.shape[0])
    _same_sparse(pairs_t, pairs_j)
    np.testing.assert_array_equal(freq_t, freq_j)
    assert tw.negative_sampling_list(freq_t) == \
        jw.negative_sampling_list(freq_j)


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    """Cores and walk artifacts of three small generated snapshots, written
    by the port's preprocessing."""
    from ctgcn_torch.preprocessing import preprocess

    base = tmp_path_factory.mktemp("toy")
    rng = np.random.default_rng(3)
    n = 90
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text(
        "".join(f"n{i}\n" for i in range(n)))
    (base / "1.format").mkdir()
    for t in range(3):
        src = rng.integers(0, n, 400)
        dst = rng.integers(0, n // (t + 1) + 5, 400) % n
        w = rng.integers(1, 4, 400)
        (base / "1.format" / f"2001-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n"
            + "".join(f"n{a}\tn{b}\t{c}\n" for a, b, c in zip(src, dst, w)))
    preprocess("CTGCN-C", {
        "base_path": str(base), "origin_folder": "1.format",
        "core_folder": "cores", "node_file": "nodes_set/nodes.csv",
        "walk_pair_folder": "walks", "node_freq_folder": "freq",
        "walk_time": 4, "walk_length": 5, "seed": 1})
    return base, n


def test_walk_artifacts_are_consistent(toy_tree):
    """The written pair matrix and frequency list are what the JAX
    package's native sampler gives for snapshot i from the port's seed of
    (seed, i)."""
    base, n = toy_tree
    names = tf.read_node_list(str(base / "nodes_set" / "nodes.csv"))
    adj = tf.get_sp_adj_mat(str(base / "1.format" / "2001-02.csv"), names)
    walks = jn.simulate_walks(adj.tocsr(), 5, 4,
                              seed=tw.snapshot_seed(1, 1))
    pairs, freq = tw.walk_pairs_and_freq(walks, n)
    _same_sparse(sp.load_npz(base / "walks" / "2001-02.npz"), pairs)
    with open(base / "freq" / "2001-02.json") as fp:
        assert json.load(fp) == jw.negative_sampling_list(freq)


def test_loader_walk_data_matches(toy_tree):
    base, n = toy_tree
    names = tf.read_node_list(str(base / "nodes_set" / "nodes.csv"))
    got = TDataLoader(names, 3).get_walk_data(
        str(base / "walks"), str(base / "freq"), 0, 3)
    ref = JDataLoader(names, 3).get_walk_data(
        str(base / "walks"), str(base / "freq"), 0, 3)
    for field in ("nbr_flat", "nbr_offsets", "degrees", "neg_logits"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))


def test_loader_core_pyramids_match(toy_tree):
    """The stacked window's validity mask equals the JAX loader's
    ``core_backend="pallas"`` bank, and every snapshot's own BSR plan
    equals its plan there without the padding blocks (zero blocks past
    ``row_ptr[-1]``) that the JAX bank adds to stack the window."""
    base, n = toy_tree
    names = tf.read_node_list(str(base / "nodes_set" / "nodes.csv"))
    got = TDataLoader(names, 3).get_core_adj_list(str(base / "cores"), 0, 3,
                                                  core_backend="pallas")
    ref = JDataLoader(names, 3).get_core_adj_list(
        str(base / "cores"), 0, 3, core_backend="pallas")
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.n_nodes == ref.n_nodes == n
    for t in range(3):
        for mine, theirs in ((got.plan_fwd[t], ref.plan_fwd),
                             (got.plan_t[t], ref.plan_t)):
            assert (mine.n_rows, mine.n_cols) == (theirs.n_rows,
                                                  theirs.n_cols)
            np.testing.assert_array_equal(mine.row_ptr.numpy(),
                                          np.asarray(theirs.row_ptr)[t])
            nb = mine.num_blocks
            assert nb == int(mine.row_ptr[-1])
            for field in ("blocks", "block_col", "block_row"):
                np.testing.assert_array_equal(
                    getattr(mine, field).numpy(),
                    np.asarray(getattr(theirs, field))[t][:nb])
            assert not np.asarray(theirs.blocks)[t][nb:].any()


def _ell_nnz(plan):
    """Nonzeros of a JAX ELL plan (one snapshot's buckets)."""
    return sum(int((np.asarray(b.vals) != 0).sum()) for b in plan.buckets)


@pytest.mark.parametrize("backend, kwargs, chosen", [
    ("auto", {}, "blocks"),
    ("dense", {}, "dense"),
    ("blocks", {}, "blocks"),
    ("ell", {}, "ell"),
    ("auto", {"dense_budget_bytes": 1000}, "ell"),
    ("auto", {"allow_blocks": False}, "dense"),
    ("auto", {"bf16_bank_budget": 2}, "blocks"),
    ("auto", {"bf16_bank_budget": 1}, "ell"),
], ids=["auto", "dense", "blocks", "ell", "auto_small_budget",
        "auto_no_blocks", "auto_bf16_fits", "auto_bf16_over"])
def test_loader_backend_matches_jax(toy_tree, backend, kwargs, chosen):
    """Every core backend, and the ``"auto"`` policy, builds the JAX
    loader's bank on the same tree: the same backend (``"auto"`` takes the
    blocks when the dense bank fits the budget, the dense bank without
    blocks, ELL above the budget), validity, dense bank, principal blocks
    and node order, and ELL plans of the same size.

    ``bf16_bank_budget`` asks for a bf16 bank under a budget of that many
    bytes an entry: 2, what a bf16 bank takes, fits; 1 does not.  At 2
    bytes an entry the f32 bank (4) would not fit, so "auto" counts the
    bf16 bank's 2 bytes as the JAX loader does."""
    base, n = toy_tree
    names = tf.read_node_list(str(base / "nodes_set" / "nodes.csv"))
    t_kw, j_kw = dict(kwargs), dict(kwargs)
    if "bf16_bank_budget" in kwargs:
        n_slots = max(len(m) for m in TDataLoader(
            names, 3).get_core_scipy_list(str(base / "cores"), 0, 3))
        budget = 3 * n_slots * n * n * t_kw.pop("bf16_bank_budget")
        del j_kw["bf16_bank_budget"]
        t_kw.update(dense_dtype=torch.bfloat16, dense_budget_bytes=budget)
        j_kw.update(dense_dtype=jnp.bfloat16, dense_budget_bytes=budget)
    got = TDataLoader(names, 3).get_core_adj_list(
        str(base / "cores"), 0, 3, core_backend=backend, **t_kw)
    ref = JDataLoader(names, 3).get_core_adj_list(
        str(base / "cores"), 0, 3, core_backend=backend, **j_kw)
    ref_backend = ("blocks" if ref.blocks is not None
                   else "dense" if ref.dense is not None
                   else "ell" if ref.ell_fwd is not None else None)
    assert got.backend == ref_backend == chosen
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    # the COO is dropped once a bank is built
    assert got.rows is None and got.plan_fwd is None
    assert got.ell_delta == (chosen == "ell")
    if got.backend == "dense":
        np.testing.assert_array_equal(got.dense.numpy(),
                                      np.asarray(ref.dense))
    elif got.backend == "blocks":
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
        for mine, theirs in zip(got.blocks, ref.blocks, strict=True):
            for a, b in zip(mine, theirs, strict=True):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b, np.float32))
    else:
        assert got.ell_delta and ref.ell_delta
        assert got.ell_bf16 == ref.ell_bf16 == ("dense_dtype" in t_kw)
        for t in range(3):
            theirs = jax.tree.map(lambda a, t=t: a[t], ref.ell_fwd)
            assert got.ell_fwd[t].nnz == _ell_nnz(theirs)
            assert (got.ell_fwd[t].n_rows, got.ell_fwd[t].n_cols) == (
                theirs.n_rows, theirs.n_cols)


def test_loader_unknown_backend_raises(toy_tree):
    base, _ = toy_tree
    names = tf.read_node_list(str(base / "nodes_set" / "nodes.csv"))
    with pytest.raises(ValueError, match="core_backend"):
        TDataLoader(names, 3).get_core_adj_list(str(base / "cores"), 0, 3,
                                                core_backend="csr")
