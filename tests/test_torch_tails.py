# coding: utf-8
"""CoreDiffusion's T-batched window tail against ``ctgcn_tpu`` with the
matching variables set (``tests/test_torch_remat.py``'s window, pinning
and tolerances: values 1e-5, gradients 1e-4; the scan tails are in
``tests/test_torch_scan_tails.py``):

  * ``batch_window_tail`` (``CTGCN_TPU_BATCH_WINDOW_TAIL=1``) on the
    blocks backend: CGCN-C and CTGCN-C, GRU and LSTM, with
    ``core_rnn_sum``'s K-batched mode and (``cvjp_batch_budget=0``) its
    lean mode, each layer's tail running the T snapshots at once;
  * the K-batched gate of ``core_rnn_sum`` counts the T snapshots.
"""
import numpy as np
import pytest
import torch

from ctgcn_torch.ops import rnn as TR
from tests.test_torch_remat import (assert_matches, jax_model, jax_reference,
                                    pin_jax, port_model, windows)  # noqa: F401

BUDGET = 512 << 20


@pytest.mark.parametrize("kind, rnn_type, cvjp_batch", [
    ("CTGCN", "GRU", BUDGET), ("CTGCN", "LSTM", BUDGET),
    ("CGCN", "GRU", BUDGET), ("CGCN", "LSTM", BUDGET),
    ("CTGCN", "LSTM", 0), ("CGCN", "GRU", 0)],
    ids=["CTGCN-GRU", "CTGCN-LSTM", "CGCN-GRU", "CGCN-LSTM",
         "CTGCN-LSTM-lean", "CGCN-GRU-lean"])
def test_batch_window_tail_equals_jax(windows, monkeypatch, kind, rnn_type,
                                      cvjp_batch):
    tpyr, jpyr = windows["blocks"]
    pin_jax(monkeypatch, CTGCN_TPU_BATCH_WINDOW_TAIL=1,
            CTGCN_TPU_CVJP_BATCH_BUDGET=cvjp_batch)
    jmodel = jax_model(kind, rnn_type)
    ref = jax_reference(jmodel, jpyr)
    model = port_model(kind, jmodel, rnn_type, batch_window_tail=True,
                       cvjp_batch_budget=cvjp_batch)
    calls = []
    real = TR._CoreRnnSum.apply
    monkeypatch.setattr(TR._CoreRnnSum, "apply",
                        lambda acc, *a: calls.append(acc.shape)
                        or real(acc, *a))
    assert_matches(model, tpyr, ref)
    # one T-batched core_rnn_sum a layer over the slots the fullest
    # snapshot keeps (of K = 4): [max kept, T, N, d]
    assert max(tpyr.kept) < 4
    assert [s[:2] for s in calls] == [(max(tpyr.kept), 2)] * 2


def test_k_batched_gate_counts_the_snapshots():
    """The K-batched mode's gate [K, N, G·H] f32 bytes scales by T for the
    T-batched tail's [K, T, N, d] prefix (the JAX gate does not)."""
    K, T, n, d, H = 4, 3, 10, 5, 6
    one = 4 * K * n * 3 * H
    assert TR._batched(False, torch.zeros(K, n, d), H, one)
    assert not TR._batched(False, torch.zeros(K, T, n, d), H, one)
    assert TR._batched(False, torch.zeros(K, T, n, d), H, T * one)
    # the T-batched sum of T shared cells equals T separate sums
    gen = torch.Generator().manual_seed(0)
    cell = TR.LSTMCell(d, H, generator=gen)
    acc = torch.randn(K, T, n, d, generator=gen)
    valid = torch.tensor([[1.0] * T] * 3 + [[1.0, 0.0, 1.0]])
    for budget in (0, T * one):
        got = TR.core_rnn_sum(cell, acc, valid, budget)
        want = torch.stack([TR.core_rnn_sum(cell, acc[:, t], valid[:, t])
                            for t in range(T)])
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
