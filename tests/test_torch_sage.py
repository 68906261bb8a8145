# coding: utf-8
"""The zoo's SAGE and TgSAGE against ``ctgcn_tpu`` on the CPU.

  * ``sample_neighbors``: the port's draws and the JAX package's are held
    to the same law (the frameworks' random numbers differ): distinct
    draws, all of them neighbours, all neighbours when deg < S, none for
    an isolated node, and neighbour frequencies uniform by a chi-square
    test at fixed seeds.
  * ``SAGE`` (sum, average and max pooling, the ``gcn`` branch, identity
    and file features) forward and gradients from the JAX parameters
    (``params_from_numpy``), dropout off, at ``num_sample`` above the
    largest degree (every node takes all its neighbours, so the draw is
    deterministic) and at ``num_sample`` None, what every config's SAGE
    entry gives.
  * The driver's window and U-neg loss for SAGE (as configured: all
    neighbours) and TgSAGE (``num_sample`` above the largest degree),
    segment and "ell", on the zoo's generated dataset
    (``tests/test_torch_zoo.py``), and the CLI on both.
  * SAGE's export: it samples and drops out with a generator seeded 0, so
    two exports are equal and differ from a dropout-free forward.

Forward within 1e-5 (rtol and atol); gradients within 1e-4 of the value
plus 1e-4 of the largest gradient (``_check_grads``), the zoo's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ctgcn_torch.nn.sage import SAGE as TSAGE
from ctgcn_torch.ops import neighbors as TN
from ctgcn_torch.training import driver as TD
from ctgcn_tpu.nn.sage import SAGE as JSAGE
from ctgcn_tpu.ops import neighbors as JN
from tests.test_torch_zoo import (EMB, HID, N, T, _compare, _features,
                                  _load, _neighbors, dataset)  # noqa: F401
from tests.test_torch_zoo import _cli_run, _driver_window_and_loss

#: the chi-square test's p-value must stay above this (fixed seeds, so
#: the test is deterministic; a wrong law gives p far below it)
P_MIN = 1e-3


def _star_table(n_rows, deg, width):
    """n_rows copies of one node whose ``deg`` neighbours are 10, 11, ...,
    padded to ``width``; a last row of degree 2 and an isolated one."""
    nbr = np.zeros((n_rows + 2, width), np.int64)
    nbr[:n_rows, :deg] = np.arange(10, 10 + deg)
    nbr[n_rows, :2] = (3, 4)
    degs = np.full(n_rows + 2, deg, np.int64)
    degs[n_rows:] = (2, 0)
    return nbr, degs


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_sample_neighbors_law(side):
    """S = 4 of 10 neighbours, 3,000 rows: each row's draws are distinct
    neighbours, every neighbour is drawn 1,200 times in expectation and
    the counts pass a chi-square test of uniformity; a row of degree 2
    < S takes both and masks the rest; an isolated row is all masked."""
    rows, deg, s = 3000, 10, 4
    nbr, degs = _star_table(rows, deg, 12)
    if side == "torch":
        idx, mask = TN.sample_neighbors(
            torch.from_numpy(nbr), torch.from_numpy(degs), s,
            torch.Generator().manual_seed(0))
        idx, mask = idx.numpy(), mask.numpy()
    else:
        idx, mask = JN.sample_neighbors(jnp.asarray(nbr, jnp.int32),
                                        jnp.asarray(degs, jnp.int32), s,
                                        jax.random.key(0))
        idx, mask = np.asarray(idx), np.asarray(mask)
    assert idx.shape == mask.shape == (rows + 2, s)
    assert mask[:rows].all()
    drawn = idx[:rows]
    assert ((drawn >= 10) & (drawn < 10 + deg)).all()
    assert all(len(set(r)) == s for r in drawn)
    counts = np.bincount(drawn.ravel() - 10, minlength=deg)
    assert stats.chisquare(counts).pvalue > P_MIN, counts
    np.testing.assert_array_equal(mask[rows], [True, True, False, False])
    assert sorted(idx[rows][:2]) == [3, 4]
    assert not mask[rows + 1].any()


def test_sample_neighbors_narrow_table():
    """A table narrower than S (every degree below S): every row takes
    all its neighbours, in table order, as in the JAX package."""
    nbr = np.array([[5, 6], [7, 0], [0, 0]], np.int64)
    degs = np.array([2, 1, 0], np.int64)
    idx, mask = TN.sample_neighbors(torch.from_numpy(nbr),
                                    torch.from_numpy(degs), 3,
                                    torch.Generator().manual_seed(0))
    jidx, jmask = JN.sample_neighbors(jnp.asarray(nbr, jnp.int32),
                                      jnp.asarray(degs, jnp.int32), 3,
                                      jax.random.key(0))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(np.where(mask, idx, -1),
                                  np.where(jmask, jidx, -1))


@pytest.mark.parametrize("pooling, num_sample, gcn, features", [
    ("sum", "above", False, False), ("average", "above", False, False),
    ("max", "above", False, False), ("sum", None, False, False),
    ("average", None, False, True), ("max", None, True, False),
    ("sum", "above", True, True)])
def test_sage_forward_and_grads_equal_jax(dataset, pooling, num_sample, gcn,
                                          features):
    """SAGE over the zoo's neighbour table (raw A; u119 isolated), dropout
    off: ``num_sample`` "above" the largest degree, or None."""
    (jn, jd), (tn, td) = _neighbors(dataset)
    if num_sample == "above":
        num_sample = int(td.max()) + 1
    in_dim, jxs, txs = _features(features)
    jmodel = JSAGE.init(jax.random.key(6), in_dim, HID, EMB,
                        num_sample=num_sample, pooling_type=pooling, gcn=gcn,
                        dropout=0.0)
    tmodel = _load(TSAGE(in_dim, HID, EMB, num_sample=num_sample,
                         pooling_type=pooling, gcn=gcn, dropout=0.0), jmodel)
    _compare(jmodel, tmodel,
             lambda m: m(jxs, (jn, jd), jax.random.key(0)),
             lambda m: m(txs, (tn, td), torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("method, change", [
    ("SAGE", {}), ("SAGE", {"adj_backend": "ell"}),
    ("TgSAGE", {"num_sample": N}), ("TgSAGE", {"num_sample": N,
                                               "adj_backend": "ell"})],
    ids=["SAGE", "SAGE-ell", "TgSAGE", "TgSAGE-ell"])
def test_driver_window_and_loss_equal_jax(dataset, method, change):
    """Both drivers' inputs, models and U-neg loss for one window, dropout
    0: the raw A and its neighbour table; SAGE as configs/uci.json gives
    it (``num_sample`` null: all neighbours), TgSAGE with ``num_sample``
    above the largest degree (its default, 5, would sample)."""
    _driver_window_and_loss(dataset, method, change)


def test_driver_num_sample_defaults():
    """Every config's SAGE entry sets ``num_sample`` to null, which stays
    None (all neighbours); TgSAGE's entries do not set it, so it is the
    driver's 5, not ``SAGE``'s 10.  ``pooling_type`` reaches the model."""
    args = {"input_dim": 8, "hid_dim": 6, "embed_dim": 4}
    gen = torch.Generator().manual_seed(0)
    assert TD.get_gnn_model("SAGE", 1, dict(args, num_sample=None),
                            gen).sage1.num_sample is None
    tg = TD.get_gnn_model("TgSAGE", 1, dict(args, pooling_type="max"), gen)
    assert tg.sage1.num_sample == tg.sage2.num_sample == 5
    assert tg.sage2.pooling_type == "max" and not tg.sage1.gcn


@pytest.mark.parametrize("method", ["SAGE", "TgSAGE"])
def test_cli_runs_each_method(dataset, tmp_path, method):
    """``--task=embedding`` as configs/uci.json gives it, at test width,
    one epoch on the CPU: finite losses, one CSV per snapshot."""
    _cli_run(dataset, tmp_path, method)


def test_export_samples_and_drops_out_deterministically(dataset):
    """The export calls the forward without a generator: SAGE then draws
    its samples and dropout from a generator seeded 0 (the JAX model from
    ``jax.random.key(0)``), so two exports agree bit for bit and differ
    from a forward without dropout."""
    _, (tn, td) = _neighbors(dataset)
    model = TSAGE(N, HID, EMB, num_sample=5, dropout=0.5,
                  generator=torch.Generator().manual_seed(0))
    fwd = TD.make_forward("TgSAGE")
    data = {"xs": None, "neighbor_data": (tn, td)}
    with torch.no_grad():
        first, second = fwd(model, data), fwd(model, data)
        model.dropout = 0.0
        plain = fwd(model, data)
    assert first.shape == (T, N, EMB)
    assert torch.equal(first, second)
    assert not torch.allclose(first, plain)
