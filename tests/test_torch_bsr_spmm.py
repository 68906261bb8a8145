# coding: utf-8
"""BSR SpMM of the port (``ctgcn_torch.ops.bsr_spmm``) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each kernel wrapper runs the plain PyTorch version over
the plan's CSR, so these tests hold the plans, their CSR, both plain
versions and ``block_spmm``'s gradient against
``ctgcn_tpu.ops.pallas_spmm``, and check the block-parallel kernel's
two-pass schedule on the CSR with numpy.  Tolerance: f32 values 1e-5,
gradients 1e-4 (sums in another order).  The CUDA kernels themselves are
held against both plain versions by ``chip_smoke.py`` on a GPU machine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ctgcn_torch.ops import bsr_spmm as T
from ctgcn_torch.training import profiling
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


def _plan_cases():
    """name -> (port plan, JAX plan, the scipy matrix it holds)."""
    cases = {}
    for name, shape in SHAPES.items():
        m = _rand_sparse(np.random.default_rng(0), *shape)
        cases[name] = (T.build_block_plan(m), J.build_block_plan(m), m)
    rng = np.random.default_rng(1)
    mats = _nested_core_mats(rng, 150, 3)
    slots = [(0, mats[0]), (2, mats[2])]
    fwd, tr = T.build_pyramid_plans(slots, 150, 4)
    jf, jt = J.build_pyramid_plans(slots, 150, 4)
    gap = sp.csr_matrix((256 - 150, 150))     # slots sit 256 rows apart
    stacked = sp.vstack([mats[0], gap, sp.csr_matrix((256, 150)),
                         mats[2]])
    cases["pyramid"] = (fwd, jf, stacked)
    cases["pyramid_t"] = (tr, jt, stacked.T)
    m = _rand_sparse(np.random.default_rng(2), 700, 900, 0.05)
    plan = T.build_block_plan(m)
    cases["padded"] = (T.pad_block_plan(plan, plan.num_blocks + 11),
                       J.pad_block_plan(J.build_block_plan(m),
                                        plan.num_blocks + 11), m)
    return cases


PLAN_CASES = ["square", "rect", "empty", "pyramid", "pyramid_t", "padded"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_csr_equals_scipy_and_scatters_to_jax_blocks(case):
    """The plan's CSR is scipy's CSR of the same (row-padded) matrix, and
    scattering it into the plan's block slots rebuilds the JAX plan's
    blocks exactly (fillers and padding blocks stay zero)."""
    plan, jplan, m = _plan_cases()[case]
    coo = sp.coo_matrix(m)
    ref = sp.csr_matrix((coo.data, (coo.row, coo.col)),
                        shape=(plan.n_rows, plan.n_cols))
    ref.sum_duplicates()
    ref.eliminate_zeros()
    ref.sort_indices()
    ptr, col = plan.csr_ptr.numpy(), plan.csr_col.numpy()
    np.testing.assert_array_equal(ptr, ref.indptr)
    np.testing.assert_array_equal(col, ref.indices)
    np.testing.assert_array_equal(plan.csr_val.numpy(),
                                  ref.data.astype(np.float32))
    np.testing.assert_array_equal(plan.csr_row.numpy(),
                                  np.repeat(np.arange(plan.n_rows),
                                            np.diff(ptr)))
    assert plan.max_row_nnz == int(np.diff(ptr).max(initial=0))
    jblocks = np.asarray(jplan.blocks)
    c_tiles = plan.n_cols // T.BLOCK
    keys = (np.asarray(jplan.block_row, np.int64)[:int(jplan.row_ptr[-1])]
            * c_tiles + np.asarray(jplan.block_col)[:int(jplan.row_ptr[-1])])
    row = plan.csr_row.numpy().astype(np.int64)
    slot = np.searchsorted(keys, (row // T.BLOCK) * c_tiles
                           + col // T.BLOCK)
    blocks = np.zeros_like(jblocks)
    blocks[slot, row % T.BLOCK, col % T.BLOCK] = plan.csr_val.numpy()
    np.testing.assert_array_equal(blocks, jblocks)


@pytest.mark.parametrize("case", ["square", "pyramid", "pyramid_t"])
def test_row_order_groups_rows_longest_first(case):
    """The row walk's order is a permutation of the rows; in the pyramid's
    forward plan a node's slot rows sit side by side; groups come by
    descending nonzero count."""
    plan = _plan_cases()[case][0]
    order = plan.row_order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(plan.n_rows))
    counts = np.diff(plan.csr_ptr.numpy())
    if case == "pyramid":
        np_pad = plan.n_cols
        nodes = order % np_pad
        k = plan.n_rows // np_pad
        np.testing.assert_array_equal(nodes.reshape(-1, k),
                                      np.repeat(nodes[::k], k).reshape(-1, k))
        totals = np.bincount(nodes, weights=counts[order])[nodes[::k]]
    else:
        totals = counts[order]
    assert np.all(np.diff(totals) <= 0)


def _two_pass(plan, x, chunk):
    """bsr_spmm_blockpar's schedule in numpy: pass 1 over chunks of the
    nonzero stream (rows inside a chunk to out, pieces of rows across an
    edge to scratch slot 0 or 1 of the chunk), pass 2 over the rows that
    cross a chunk edge (``cross_rows``: pieces added in chunk order), the
    plan's runs of empty rows zero.  Returns out and how many times each
    row was written."""
    ptr, row = plan.csr_ptr.numpy(), plan.csr_row.numpy()
    col, val = plan.csr_col.numpy(), plan.csr_val.numpy()
    nnz = len(val)
    out = np.full((plan.n_rows, x.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.n_rows, int)
    scratch = np.full((2 * -(-nnz // chunk), x.shape[1]), np.nan,
                      np.float32)
    for c in range(-(-nnz // chunk)):
        start, end = c * chunk, min(nnz, (c + 1) * chunk)
        for r in np.unique(row[start:end]):
            sel = np.arange(start, end)[row[start:end] == r]
            piece = (val[sel, None] * x[col[sel]]).sum(0)
            if ptr[r] >= start and ptr[r + 1] <= end:
                out[r] = piece
                writes[r] += 1
            else:
                slot = 2 * c + int(ptr[r] > start)
                assert np.isnan(scratch[slot]).all()   # one piece a slot
                scratch[slot] = piece
    for r, first, k1 in T.cross_rows(ptr, chunk):
        acc = scratch[first].copy()
        for k in range(first // 2 + 1, k1 + 1):
            acc += scratch[2 * k]
        out[r] = acc
        writes[r] += 1
    for r, n in plan.empty_runs.numpy():
        out[r:r + n] = 0
        writes[r:r + n] += 1
    return out, writes


@pytest.mark.parametrize("chunk", ["plan", 7, 1])
@pytest.mark.parametrize("case", ["pyramid", "pyramid_t", "padded"])
def test_nonzero_partition_covers_each_nonzero_once(case, chunk):
    """The block-parallel kernel's chunks of the nonzero stream (the
    plan's own chunk, derived from its nnz, and two others) cover every
    nonzero once, in row order; its two passes and the zero fill write
    every output row exactly once and give the plain CSR product."""
    plan = _plan_cases()[case][0]
    if chunk == "plan":
        chunk = plan.chunk
        np.testing.assert_array_equal(plan.cross_rows.numpy(),
                                      T.cross_rows(plan.csr_ptr.numpy(),
                                                   chunk))
    row = plan.csr_row.numpy()
    starts = np.arange(0, plan.nnz, chunk)
    covered = np.concatenate([np.arange(s, min(plan.nnz, s + chunk))
                              for s in starts] or [np.zeros(0, int)])
    np.testing.assert_array_equal(covered, np.arange(plan.nnz))
    assert np.all(np.diff(row) >= 0)
    x = np.random.default_rng(8).standard_normal(
        (plan.n_cols, 64)).astype(np.float32)
    out, writes = _two_pass(plan, x, chunk)
    assert (writes == 1).all()
    ref = T.bsr_spmm_csr_plain(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=ATOL)


def test_device_plan_leaves_blocks_behind():
    """``to`` moves the CSR; the dense blocks, which no kernel reads, come
    along only when asked."""
    plan = T.build_block_plan(
        _rand_sparse(np.random.default_rng(9), 200, 200, 0.05))
    moved = plan.to("cpu")
    assert moved.blocks is None and moved.num_blocks == plan.num_blocks
    x = torch.ones(plan.n_cols, 64)
    with pytest.raises(ValueError, match="blocks=True"):
        T.bsr_spmm_plain(moved, x)
    torch.testing.assert_close(T.bsr_spmm_rowwalk(moved, x),
                               T.bsr_spmm_plain(plan.to("cpu", blocks=True),
                                                x))


@pytest.mark.parametrize("case, kernel", [
    ("square", "bsr_spmm_rowwalk"), ("pyramid", "bsr_spmm_rowwalk"),
    ("pyramid_t", "bsr_spmm_rowwalk"), ("row_at_limit", "bsr_spmm_rowwalk"),
    ("row_past_limit", "bsr_spmm_blockpar")])
def test_dispatch_by_longest_row(case, kernel):
    """Plans whose longest row fits one warp's walk take the row walk;
    a plan with a longer row (a hub in a transpose) takes the
    block-parallel kernel."""
    if case.startswith("row_"):
        m = sp.lil_matrix((300, 300), dtype=np.float32)
        m[7, :T.ROWWALK_MAX_ROW + (case == "row_past_limit")] = 1.0
        plan = T.build_block_plan(m)
    else:
        plan = _plan_cases()[case][0]
    assert T.dispatch(plan).__name__ == kernel
    assert (plan.max_row_nnz > T.ROWWALK_MAX_ROW) == (kernel ==
                                                  "bsr_spmm_blockpar")


# (n_rows, n_cols, density, d): in the JAX package the first takes the
# block-parallel branch (_spmm_v2_kernel), the second has n_cols * d * 4 >
# 10 MB and takes the row-walk branch (_spmm_kernel)
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
    assert (plan.n_cols * d * 4 > J._V2_X_VMEM_BUDGET) == (branch ==
                                                           "rowwalk")
    x = rng.standard_normal((plan.n_cols, d)).astype(np.float32)
    ref = np.asarray(J._block_spmm_raw(jplan, jnp.asarray(x),
                                       interpret=True))
    xt = torch.from_numpy(x)
    for fn in (T.bsr_spmm_plain, T.bsr_spmm_csr_plain, T.bsr_spmm_rowwalk,
               T.bsr_spmm_blockpar, T.block_spmm_raw):
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
    names = ("spmm.launches.bsr_spmm_rowwalk",
             "spmm.launches.bsr_spmm_blockpar")
    before = tuple(map(profiling.counter, names))
    x = torch.ones(plan.n_cols, 64)
    T.bsr_spmm_rowwalk(plan, x)
    T.bsr_spmm_blockpar(plan, x)
    assert tuple(map(profiling.counter, names)) == before


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
