"""The yardstick's arithmetic on known inputs, the check for JAX modules,
and the reference's k-core numbers and walks against the port's at a
small size."""
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import program
import tracing
from reference import ctgcn, gcrn, kcore, uneg, walks
from reference.graph import row_normalised
from roofline import spmm_bound_s

H100 = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_spmm_bound_by_bytes_and_by_operations():
    # 1000 nonzeros, 100 rows, 50 columns named, d 128
    moved = 1000 * 8 + 101 * 4 + 50 * 128 * 4 + 100 * 128 * 4
    assert spmm_bound_s(1000, 100, 50, 128, H100) == pytest.approx(
        moved / 3.35e12)
    # a dense row block: operations bind
    flops = 2.0 * 10**7 * 4096
    got = spmm_bound_s(10**7, 10, 10, 4096, H100)
    assert got == pytest.approx(max(flops / 67e12, (10**7 * 8 + 44 + 2 * 10
                                                    * 4096 * 4) / 3.35e12))
    assert got == pytest.approx(flops / 67e12)


def test_union_of_overlapping_intervals():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 20.0, 5.0),
           ("d", 21.0, 1.0), ("e", 30.0, 0.0)]
    assert tracing.union_us(ops) == 20.0
    assert tracing.union_us([]) == 0.0


def test_markers_split_ranges():
    m = "spin"
    ops = [("k0", 0, 1), (m, 1, 1), ("k1", 2, 3), (m, 5, 1), ("k2", 6, 2),
           (m, 8, 1), ("k3", 9, 4), (m, 13, 1)]
    log = [("spmm", "open"), ("spmm", "close"), ("loss", "open"),
           ("loss", "close")]
    plain, labels, inside = tracing.split_markers(ops, m, log)
    assert [o[0] for o in plain] == ["k0", "k1", "k2", "k3"]
    assert labels == ["-", "spmm", "-", "loss"]
    assert inside == {"spmm": 3.0, "loss": 4.0}
    # a marker the log does not hold: no ranges
    assert tracing.split_markers(ops, m, log[:3])[2] is None
    assert tracing.kernel_class("sm80_xmma_gemm_f32f32") == "gemm"
    assert tracing.kernel_class("bsr_spmm_rowwalk_f32") == "spmm"


def test_breakdown_names_gaps_by_range():
    ops = [("k0", 0.0, 1.0), ("k1", 11.0, 1.0), ("k2", 13.0, 1.0)]
    b = tracing.breakdown(ops, ["-", "loss", "-"])
    assert b["idle_gaps"][0] == ["loss: before k1", 10e-6]
    assert b["device_ops"][0][1] == 1e-6


@pytest.mark.parametrize("names,found", [
    (["ctgcn_torch", "ctgcn_torch.ops", "torch", "jaxtyping"], []),
    (["jax", "jax.numpy", "ctgcn_tpu.ops", "optax", "flax.linen"],
     ["ctgcn_tpu.ops", "flax.linen", "jax", "jax.numpy", "optax"]),
    (["jaxlib.xla_client", "ctgcn_tpu_extra"], ["jaxlib.xla_client"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert program.forbidden_modules(names) == found


def _graph(n=30, seed=3):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.2, random_state=seed, format="csr")
    a = ((a + a.T) > 0).astype(np.float64)
    a.setdiag(0)
    a.eliminate_zeros()
    return a.tocsr()


def test_flops_of_a_known_window():
    a = _graph()
    cfg = {"duration": 1, "hid_dim": 6, "embed_dim": 4,
           "diffusion_layer_num": 2, "model_type": "C", "trans_layer_num": 1,
           "rnn_type": "GRU", "trans_activate_type": "L", "dropout": 0.5}
    n = a.shape[0]
    prep = ctgcn.prepare([a], cfg, "cpu")
    K = len(prep.slots[0])
    nnz = sum(s.nnz for s in prep.slots[0])
    gru = lambda d, h: 2.0 * n * 3 * h * (d + h)  # noqa: E731
    want_f = (2.0 * nnz * 6 + K * gru(6, 4) + 2.0 * nnz * 4 + K * gru(4, 4)
              + gru(4, 4))
    want_b = (2.0 * nnz * 6 + 2 * K * gru(6, 4) + 2.0 * nnz * 4
              + 2 * K * gru(4, 4) + 2 * gru(4, 4))
    assert ctgcn.flops(prep, cfg) == pytest.approx((want_f, want_b))
    prep = gcrn.prepare([a], cfg, "cpu")
    e = (a + sp.eye(n)).nnz
    want_f = 2.0 * e * 6 + 2.0 * e * 4 + 2.0 * n * 6 * 4 + gru(4, 4)
    assert gcrn.flops(prep, cfg)[0] == pytest.approx(want_f)
    f, b = uneg.flops(3, 2, 10, 5, 4)
    assert f == 3 * 2 * (2.0 * 10 * 5 * 4 + 5 * 4 + 2.0 * 10 * 4)
    assert b == 2 * f


def test_kcore_and_walks_match_the_port():
    from ctgcn_torch.preprocessing.kcore import (core_numbers,
                                                 kcore_subgraph)
    from ctgcn_torch.preprocessing.walks import (negative_sampling_list,
                                                 simulate_walks,
                                                 walk_pairs_and_freq)
    a = _graph(80, 5)
    core = kcore.core_numbers(a)
    assert np.array_equal(core, core_numbers(a))
    for k, m in kcore.kcore_matrices(a):
        assert (abs(m - kcore_subgraph(a, core, k).tocsr()) > 0).nnz == 0
    seed = walks.snapshot_seed(2**31 + 5, 3)
    w = walks.walks(a, 4, 3, seed)
    assert np.array_equal(w, simulate_walks(a, 4, 3, seed=seed))
    pairs, counts = walks.tables(w, 80)
    pm, freq = walk_pairs_and_freq(w.astype(np.int32), 80)
    assert ((pm.tocsr() != 0) != (pairs != 0)).nnz == 0
    assert np.array_equal(np.bincount(np.asarray(
        negative_sampling_list(freq), np.int64), minlength=80), counts)


def test_row_normalised_rows_sum_to_one():
    m = row_normalised(_graph())
    assert np.allclose(np.asarray(m.sum(axis=1)).ravel(), 1.0)


def test_draw_faults_catch_a_repeated_slot():
    pairs = sp.csr_matrix(np.array([[0, 1, 1, 1], [1, 0, 0, 0], [1, 0, 0, 1],
                                    [1, 0, 1, 0]], np.float64))
    tabs = uneg.Tables([pairs], [np.array([1, 1, 0, 2])], "cpu")
    batch = torch.tensor([0, 1])
    good = torch.tensor([[[2, 0], [0, 1]]])
    neg = torch.tensor([[0, 3]])
    assert uneg.draw_faults(tabs, batch, good, neg) == 0
    assert uneg.draw_faults(tabs, batch, torch.tensor([[[1, 1], [0, 1]]]),
                            neg) == 1
    assert uneg.draw_faults(tabs, batch, good, torch.tensor([[2, 3]])) == 1
    assert math.isfinite(float(uneg.loss(torch.randn(1, 4, 3), batch,
                                         torch.tensor([True, True]), tabs,
                                         good, neg, 5.0)))


def _walk_tables(n=3000, T=2, seed=11):
    """Reference tables of skewed counts and wide partner runs, and the
    port's ``WalkData`` of the same tables."""
    from ctgcn_torch.losses import WalkData
    rng = np.random.default_rng(seed)
    pairs, counts = [], []
    for _ in range(T):
        deg = rng.integers(1, 120, n)
        rows = np.repeat(np.arange(n), deg)
        cols = rng.integers(0, n, rows.size)
        m = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
        m.data[:] = 1.0
        m.sort_indices()
        pairs.append(m)
        c = (rng.pareto(1.2, n) * 20).astype(np.int64)
        c[rng.random(n) < 0.1] = 0
        counts.append(c)
    tabs = uneg.Tables(pairs, counts, "cpu")
    flat = np.zeros((T, max(p.indices.size for p in pairs)), np.int32)
    for t, p in enumerate(pairs):
        flat[t, :p.indices.size] = p.indices
    with np.errstate(divide="ignore"):
        logits = np.stack([np.log(c.astype(np.float64)).astype(np.float32)
                           for c in counts])
    walk = WalkData(
        torch.from_numpy(flat),
        torch.from_numpy(np.stack([p.indptr[:-1] for p in pairs])
                         .astype(np.int32)),
        torch.from_numpy(np.stack([np.diff(p.indptr) for p in pairs])
                         .astype(np.int32)),
        torch.from_numpy(logits))
    return tabs, walk


def test_draw_fits_pass_the_port_and_fail_planted_samplers():
    from ctgcn_torch.losses import sample_uneg
    tabs, walk = _walk_tables()
    S, g = 20, torch.Generator().manual_seed(3)
    batches = []
    for _ in range(4):
        idx = torch.randperm(3000, generator=g)[:1024]
        j, neg = sample_uneg(walk, idx, S, g)
        batches.append({"batch": idx, "mask": torch.ones(1024, dtype=bool),
                        "j": j, "neg": neg})
    assert uneg.table_mismatch(tabs, walk.neg_logits) == 0
    assert abs(uneg.negative_fit(tabs, [b["neg"] for b in batches])) \
        < uneg.Z_LIMIT
    assert abs(uneg.slot_fit(tabs, batches)) < uneg.Z_LIMIT
    # a table of equal weights over the same nodes
    flat = torch.where(torch.isfinite(walk.neg_logits), 0.0, -math.inf)
    assert uneg.table_mismatch(tabs, flat) > 0
    # the same table as log probabilities is the same table
    assert uneg.table_mismatch(
        tabs, walk.neg_logits - torch.logsumexp(walk.neg_logits, 1,
                                                keepdim=True)) == 0
    # negatives drawn uniformly over the nodes of non-zero count
    support = [torch.nonzero(c > 0).flatten() for c in tabs.counts]
    uniform = [torch.stack([s[torch.randint(len(s), (S,), generator=g)]
                            for s in support]) for _ in range(4)]
    assert abs(uneg.negative_fit(tabs, uniform)) > uneg.Z_LIMIT
    # the first S partners of every node
    first = [dict(b, j=torch.arange(S).expand_as(b["j"]).clone())
             for b in batches]
    assert abs(uneg.slot_fit(tabs, first)) > uneg.Z_LIMIT
