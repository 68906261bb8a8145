# coding: utf-8
"""The zoo's GCRN against ``ctgcn_tpu`` on the CPU, on the zoo's generated
dataset (``tests/test_torch_zoo.py``: N = 120, two weighted snapshots).

  * ``GCRN`` with a GRU and with an LSTM, identity and file-like
    features, on the segment SpMM and on the kernels' plans (their plain
    versions here), from the JAX parameters (``params_from_numpy``: the
    [T]-stacked ``gcns`` leaves become one GCN a step), dropout off:
    forward within 1e-5 (rtol and atol), parameter gradients within 1e-4
    of the value plus 1e-4 of the largest gradient (the zoo's tolerances).
  * The parity traps: the driver builds GCRN from the arguments the JAX
    factory passes only (``feature_pre``, ``feature_dim`` and ``layer_num``
    are ignored: two convolutions on identity features), and each step
    draws its own dropout mask from the generator; without one (the
    export) nothing is dropped.
  * The driver's window (D^-1 (A + I)) and U-neg loss against the JAX
    driver's, segment and "ell", GRU and LSTM, and the CLI.
"""
import jax
import numpy as np
import pytest
import torch

from ctgcn_torch.nn import gcn as TG
from ctgcn_torch.training import driver as TD
from ctgcn_tpu.nn.gcn import GCRN as JGCRN
from ctgcn_tpu.training import driver as JD
from tests.test_torch_zoo import (EMB, HID, N, T, _cli_run, _compare,
                                  _driver_window_and_loss, _features, _load,
                                  _windows, dataset)  # noqa: F401


@pytest.mark.parametrize("rnn_type, features, adj_backend", [
    ("GRU", False, "segment"), ("LSTM", False, "segment"),
    ("GRU", True, "ell"), ("LSTM", True, "ell")])
def test_gcrn_forward_and_grads_equal_jax(dataset, rnn_type, features,
                                          adj_backend):
    tgraphs, jwin = _windows(dataset, True, True, adj_backend)
    in_dim, jxs, txs = _features(features)
    jmodel = JGCRN.init(jax.random.key(11), in_dim, HID, EMB, duration=T,
                        dropout=0.5, rnn_type=rnn_type)
    tmodel = _load(TG.GCRN(in_dim, HID, EMB, T, dropout=0.5,
                           rnn_type=rnn_type), jmodel)
    assert len(tmodel.gcns) == T
    _compare(jmodel, tmodel, lambda m: m(jxs, jwin),
             lambda m: m(txs, tgraphs))


def test_gcrn_without_bias_equals_jax(dataset):
    """``bias: false``: no GCN bias, zero GRU biases, in both packages."""
    tgraphs, jwin = _windows(dataset, True, True, "segment")
    jmodel = JGCRN.init(jax.random.key(12), N, HID, EMB, duration=T,
                        bias=False)
    tmodel = _load(TG.GCRN(N, HID, EMB, T, bias=False), jmodel)
    assert tmodel.gcns[0].gc1.bias is None
    _compare(jmodel, tmodel, lambda m: m(None, jwin),
             lambda m: m(None, tgraphs))


def test_driver_ignores_gcrn_keys_the_jax_factory_does_not_pass():
    """configs' GCRN entries give ``feature_pre``, ``feature_dim: 500`` and
    ``layer_num``; neither factory reads them, so GCRN has two graph
    convolutions (input -> hid -> embed) a step on identity features, and
    the parameter trees have the same names and shapes."""
    args = {"input_dim": N, "hid_dim": HID, "embed_dim": EMB,
            "feature_pre": True, "feature_dim": 7, "layer_num": 5,
            "dropout": 0.5, "bias": True, "rnn_type": "LSTM"}
    jmodel = JD.get_gnn_model("GCRN", T, dict(args), jax.random.key(0))
    tmodel = TD.get_gnn_model("GCRN", T, dict(args),
                              torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert shapes["gcns.1.gc1.weight"] == (N, HID)
    assert shapes["gcns.1.gc2.weight"] == (HID, EMB)
    assert len(tmodel.gcns) == T and tmodel.rnn.is_lstm
    assert tmodel.gcns[0].dropout == 0.5
    _load(tmodel, jmodel)


def test_each_step_draws_its_own_dropout_mask(dataset, monkeypatch):
    """Two steps with equal parameters on equal graphs: with a generator
    their normalized GCN outputs (what the time RNN reads) differ, since
    each step draws its own mask, as each JAX step takes its own key of
    ``split(key, T)``; without one they are equal (no dropout)."""
    tgraphs, _ = _windows(dataset, True, True, "segment")
    model = TG.GCRN(N, HID, EMB, 2, dropout=0.5,
                    generator=torch.Generator().manual_seed(0))
    model.gcns[1].load_state_dict(model.gcns[0].state_dict())
    seen = []
    scan = TG.rnn_scan

    def spy(cell, hx):
        seen.append(hx.detach())
        return scan(cell, hx)

    monkeypatch.setattr(TG, "rnn_scan", spy)
    graphs = (tgraphs[0], tgraphs[0])
    with torch.no_grad():
        model(None, graphs)
        model(None, graphs, generator=torch.Generator().manual_seed(1))
    (quiet, drop) = seen
    torch.testing.assert_close(quiet[0], quiet[1], rtol=0, atol=0)
    assert not torch.allclose(drop[0], drop[1])
    rows = torch.linalg.vector_norm(drop, dim=-1)
    torch.testing.assert_close(rows, torch.ones_like(rows))


@pytest.mark.parametrize("change", [
    {}, {"adj_backend": "ell"}, {"rnn_type": "LSTM"}],
    ids=["segment", "ell", "LSTM"])
def test_driver_window_and_loss_equal_jax(dataset, change):
    """Both drivers' window (GCRN's D^-1 (A + I), as GCN's), models and
    U-neg loss, dropout 0."""
    _driver_window_and_loss(dataset, "GCRN", change)


def test_cli_runs_gcrn(dataset, tmp_path):
    """configs/uci.json's GCRN entry at test width (duration 7, so one
    window of both snapshots), one epoch on the CPU: finite losses, one
    CSV per snapshot, the model file."""
    _cli_run(dataset, tmp_path, "GCRN")
