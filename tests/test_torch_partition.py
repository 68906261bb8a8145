# coding: utf-8
"""The host plans of the port's ``parallel/`` against ``ctgcn_tpu``'s:
``partition_graph``, ``partition_graph_halo`` and ``partition_pyramid_halo``
give the JAX package's arrays, array for array (exact equality), at P = 1,
3, 4 and 8, on a random graph with a hub row, a banded graph, and a graph
so small that its last parts hold no node; the pyramid also skips a core
equal to the one before it.  Each part's ``CsrPlan`` pair (the padding
dropped) multiplies like its slab of the matrix."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.ops.bsr_spmm import bsr_spmm_csr_plain
from ctgcn_torch.parallel import core_partition as TC
from ctgcn_torch.parallel import graph_partition as TG
from ctgcn_tpu.parallel import core_partition as JC
from ctgcn_tpu.parallel import graph_partition as JG

PARTS = (1, 3, 4, 8)


def _hub(n=90, seed=0):
    """A random weighted symmetric graph whose node 5 touches most others."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.06) * rng.integers(1, 4, (n, n))
    a[5, rng.random(n) < 0.8] = 2
    a = np.triu(a, 1)
    return sp.coo_matrix((a + a.T).astype(np.float32))


def _band(n=90):
    return sp.diags([np.full(n - abs(o), 1.0 + abs(o)) for o in (-3, -1, 0,
                                                                 1, 3)],
                    [-3, -1, 0, 1, 3], shape=(n, n)).tocoo()


def _tiny():
    """20 nodes: at P = 8, rpp = 8, so parts 3-7 own no node."""
    return _hub(20, seed=1)


GRAPHS = {"hub": _hub, "band": _band, "tiny": _tiny}


def _core_mats(a, levels=(4, 4, 2, 1)):
    """Nested cores of ``a``, max core first; the repeated level makes a
    core equal to the one before it (a skipped delta slot)."""
    csr = sp.csr_matrix(a)
    deg = np.asarray((csr != 0).sum(1)).ravel()
    return [sp.csr_matrix(csr.multiply(np.outer(deg >= k, deg >= k)))
            for k in levels]


def _kept(mats):
    """The cores the pyramid keeps: each that differs from the one before
    it."""
    return [m for j, m in enumerate(mats)
            if j == 0 or abs(m - mats[j - 1]).sum() != 0]


def _assert_same(port, jax_obj, fields):
    for f in fields:
        got, ref = getattr(port, f), getattr(jax_obj, f)
        if isinstance(ref, int):
            assert got == ref, f
        else:
            ref = np.asarray(ref)
            assert got.dtype == ref.dtype, f
            np.testing.assert_array_equal(got, ref, err_msg=f)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_graph_equals_jax(graph, parts):
    mat = GRAPHS[graph]()
    _assert_same(TG.partition_graph(mat, parts),
                 JG.partition_graph(mat, parts),
                 ("rows", "cols", "vals", "rows_per_part", "n_cols"))


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_graph_halo_equals_jax(graph, parts):
    mat = GRAPHS[graph]()
    port = TG.partition_graph_halo(mat, parts)
    ref = JG.partition_graph_halo(mat, parts)
    _assert_same(port, ref, (
        "local_rows", "local_cols", "local_vals", "remote_rows",
        "remote_idx", "remote_vals", "halo_send", "rows_per_part", "n_cols",
        "halo_width"))
    assert port.comm_rows_per_chip == ref.comm_rows_per_chip


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_pyramid_halo_equals_jax(graph, parts):
    mat = GRAPHS[graph]()
    mats = _core_mats(mat)
    n = mat.shape[0]
    port = TC.partition_pyramid_halo(mats, n, parts, num_slots=5)
    ref = JC.partition_pyramid_halo(mats, n, parts, num_slots=5)
    _assert_same(port, ref, (
        "local_rows", "local_cols", "local_vals", "remote_rows",
        "remote_idx", "remote_vals", "halo_send", "valid", "rows_per_part",
        "n_nodes", "halo_width", "num_slots"))
    # the repeated core is skipped: fewer kept slots than cores
    kept = _kept(mats)
    assert len(kept) < len(mats)
    np.testing.assert_array_equal(port.valid, np.arange(5) < len(kept))


def _full_from_parts(parts_plans, x_parts, n_flat_of):
    """Each part's products from its plans and a receive buffer assembled
    from the other parts' x rows by index."""
    outs = []
    for p, part in enumerate(parts_plans):
        recv = torch.cat([x_parts[q][part_q.send[p]]
                          for q, part_q in enumerate(parts_plans)])
        out = (bsr_spmm_csr_plain(part.local_fwd, x_parts[p])
               + bsr_spmm_csr_plain(part.remote_fwd, recv))
        outs.append(out.reshape(n_flat_of, -1, x_parts[p].shape[1]))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_halo_part_plans_multiply_like_the_matrix(graph, parts):
    """The parts' plans (zero padding dropped) and send tables give
    A @ x and, for the pyramid, Δ_k @ x for every kept slot."""
    mat = GRAPHS[graph]()
    n = mat.shape[0]
    rng = np.random.default_rng(2)
    hpg = TG.partition_graph_halo(mat, parts)
    x = torch.from_numpy(rng.standard_normal((hpg.n_rows, 4))
                         .astype(np.float32))
    rpp = hpg.rows_per_part
    x_parts = list(x.split(rpp))
    plans = [hpg.part(p) for p in range(parts)]
    for part in plans:
        assert part.local_fwd.nnz + part.remote_fwd.nnz == (
            (hpg.local_vals[part.index] != 0).sum()
            + (hpg.remote_vals[part.index] != 0).sum())
    got = _full_from_parts(plans, x_parts, 1)[0, :n]
    ref = mat.toarray() @ x.numpy()[:n]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    mats = _core_mats(mat)
    ppyr = TC.partition_pyramid_halo(mats, n, parts)
    plans = [ppyr.part(p) for p in range(parts)]
    got = _full_from_parts(plans, x_parts, ppyr.num_slots)[:, :n]
    kept = _kept(mats)
    for k, cur in enumerate(kept):
        delta = (cur - kept[k - 1]) if k else cur
        np.testing.assert_allclose(got[k].numpy(),
                                   delta.toarray() @ x.numpy()[:n],
                                   rtol=1e-5, atol=1e-5, err_msg=str(k))


def test_part_rows_and_empty_parts():
    """rpp and each part's real rows; at N = 20 over 8 parts the last five
    own none, and their plans hold no nonzero."""
    assert TG.rows_per_part(20, 8) == 8
    assert [TG.own_rows(20, 8, p) for p in range(4)] == [
        (0, 8), (8, 8), (16, 4), (24, 0)]
    hpg = TG.partition_graph_halo(_tiny(), 8)
    for p in range(3, 8):
        part = hpg.part(p)
        assert part.own[1] == 0
        assert part.local_fwd.nnz == part.remote_fwd.nnz == 0
