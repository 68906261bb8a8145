# coding: utf-8
"""BSR SpMM of the port (``ctgcn_torch.ops.bsr_spmm``) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each kernel wrapper runs the plain PyTorch version, so
these tests hold the plain version, the plans and ``block_spmm``'s
gradient against ``ctgcn_tpu.ops.pallas_spmm``.  Tolerance: f32 values
1e-5, gradients 1e-4 (sums in another order).  The CUDA kernels
themselves are held against the plain version by ``chip_smoke.py`` on a
GPU machine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.ops import bsr_spmm as T
from ctgcn_tpu.ops import pallas_spmm as J

ATOL, GRAD_ATOL = 1e-5, 1e-4


def _rand_sparse(rng, n_rows, n_cols, density):
    dense = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    dense *= rng.random((n_rows, n_cols)).astype(np.float32)
    return sp.coo_matrix(dense)


def _same_plan(mine, theirs):
    assert (mine.n_rows, mine.n_cols) == (theirs.n_rows, theirs.n_cols)
    for field in ("blocks", "block_col", "block_row", "row_ptr"):
        np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                      np.asarray(getattr(theirs, field)))


def _nested_core_mats(rng, n, k):
    base = (rng.random((n, n)) < 0.08) * rng.random((n, n))
    base = np.triu(base, 1) + np.triu(base, 1).T
    deg = (base != 0).sum(1)
    return [sp.csr_matrix(base * np.outer(deg >= c, deg >= c))
            for c in sorted(np.unique(deg))[-k:][::-1]]


SHAPES = {
    "square": (300, 300, 0.05),
    "rect": (100, 260, 0.1),
    "empty": (64, 64, 0.0),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plans_equal_jax(shape):
    m = _rand_sparse(np.random.default_rng(0), *SHAPES[shape])
    fwd, tr = T.build_block_plans(m)
    jf, jt = J.build_block_plans(m)
    _same_plan(fwd, jf)
    _same_plan(tr, jt)
    # padding: repeats the last row tile, zero blocks past row_ptr[-1]
    _same_plan(T.pad_block_plan(fwd, fwd.num_blocks + 5),
               J.pad_block_plan(jf, fwd.num_blocks + 5))


def test_pyramid_plans_equal_jax():
    rng = np.random.default_rng(1)
    mats = _nested_core_mats(rng, 150, 3)
    slots = [(0, mats[0]), (2, mats[2])]     # slot 1 absent
    fwd, tr = T.build_pyramid_plans(slots, 150, 4)
    jf, jt = J.build_pyramid_plans(slots, 150, 4)
    _same_plan(fwd, jf)
    _same_plan(tr, jt)


def test_chunks_cover_each_row_run():
    """Every row tile's run of blocks (padding included) is cut into
    consecutive chunks of at most CHUNK blocks, in block order."""
    m = _rand_sparse(np.random.default_rng(2), 700, 900, 0.05)
    plan = T.pad_block_plan(T.build_block_plan(m),
                            T.build_block_plan(m).num_blocks + 11)
    cp, rcp = plan.chunk_ptr.numpy(), plan.row_chunk_ptr.numpy()
    br = plan.block_row.numpy()
    assert cp[0] == 0 and cp[-1] == plan.num_blocks
    assert np.all(np.diff(cp) >= 1) and np.all(np.diff(cp) <= T.CHUNK)
    for r in range(plan.n_rows // T.BLOCK):
        for c in range(rcp[r], rcp[r + 1]):
            assert np.all(br[cp[c]:cp[c + 1]] == r)
    assert rcp[-1] == len(cp) - 1


# (n_rows, n_cols, density, d): the first takes the block-parallel branch
# (_spmm_v2_kernel), the second has n_cols * d * 4 > 10 MB and takes the
# row-walk branch (_spmm_kernel)
BRANCHES = {
    "blockpar": (300, 300, 0.05, 128),
    "rowwalk": (512, 20480, 0.0003, 256),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("padded", [False, True])
def test_plain_products_equal_pallas_interpret(branch, padded):
    n_rows, n_cols, density, d = BRANCHES[branch]
    rng = np.random.default_rng(3)
    m = _rand_sparse(rng, n_rows, n_cols, density)
    plan = T.build_block_plan(m)
    jplan = J.build_block_plan(m)
    if padded:
        plan = T.pad_block_plan(plan, plan.num_blocks + 3)
        jplan = J.pad_block_plan(jplan, plan.num_blocks)
    assert (plan.n_cols * d * 4 > T.BLOCKPAR_X_BYTES) == (branch == "rowwalk")
    x = rng.standard_normal((plan.n_cols, d)).astype(np.float32)
    ref = np.asarray(J._block_spmm_raw(jplan, jnp.asarray(x),
                                       interpret=True))
    xt = torch.from_numpy(x)
    for fn in (T.bsr_spmm_plain, T.block_spmm_raw):
        np.testing.assert_allclose(fn(plan, xt).numpy(), ref, rtol=1e-5,
                                   atol=ATOL)


@pytest.mark.parametrize("d", [40, 130])
def test_block_spmm_grad_equals_jax_vjp(d):
    rng = np.random.default_rng(4)
    m = _rand_sparse(rng, 300, 280, 0.05)
    fwd, tr = T.build_block_plans(m)
    jf, jt = J.build_block_plans(m)
    x = rng.standard_normal((280, d)).astype(np.float32)
    w = rng.standard_normal((fwd.n_rows, d)).astype(np.float32)

    def jloss(xx):
        return jnp.sum(jnp.sin(J.block_spmm(jf, jt, xx, interpret=True))
                       * w)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tval = (torch.sin(T.block_spmm(fwd, tr, xt)) * torch.from_numpy(w)).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=GRAD_ATOL)


def test_pyramid_spmm_equals_jax():
    rng = np.random.default_rng(5)
    mats = _nested_core_mats(rng, 150, 3)
    slots = list(enumerate(mats))
    fwd, tr = T.build_pyramid_plans(slots, 150, 3)
    jf, jt = J.build_pyramid_plans(slots, 150, 3)
    x = rng.standard_normal((150, 24)).astype(np.float32)
    got = T.pyramid_spmm(fwd, tr, torch.from_numpy(x), 3, 150)
    ref = J.pyramid_spmm(jf, jt, jnp.asarray(x), 3, 150, interpret=True)
    assert got.shape == (3, 150, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=ATOL)


def test_cpu_wrappers_count_no_launch():
    m = _rand_sparse(np.random.default_rng(6), 200, 200, 0.05)
    plan = T.build_block_plan(m)
    before = (T.bsr_spmm_rowwalk.launches, T.bsr_spmm_blockpar.launches)
    x = torch.ones(plan.n_cols, 64)
    T.bsr_spmm_rowwalk(plan, x)
    T.bsr_spmm_blockpar(plan, x)
    assert (T.bsr_spmm_rowwalk.launches,
            T.bsr_spmm_blockpar.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "layout"])
def test_wrappers_reject_bad_input(bad):
    plan = T.build_block_plan(
        _rand_sparse(np.random.default_rng(7), 200, 200, 0.05))
    x = {"dtype": torch.ones(plan.n_cols, 64, dtype=torch.float64),
         "width": torch.ones(plan.n_cols, 70),
         "rows": torch.ones(plan.n_cols + 128, 64),
         "layout": torch.ones(64, plan.n_cols).T}[bad]
    for fn in (T.bsr_spmm_rowwalk, T.bsr_spmm_blockpar):
        with pytest.raises(ValueError):
            fn(plan, x)
