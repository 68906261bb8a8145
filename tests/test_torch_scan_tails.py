# coding: utf-8
"""CoreDiffusion's scan tails against ``ctgcn_tpu`` with the matching
variables set (``tests/test_torch_remat.py``'s window, pinning and
tolerances: values 1e-5, gradients 1e-4): ``core_vjp=False``
(``CTGCN_TPU_CORE_VJP=0``) under the tail budget (``rnn_scan``), over it
with the prefix materialized (``_core_rnn_scan_acc``) and with
``acc_materialize_budget=0`` (the fused running sums,
``_core_rnn_scan_remat``, delta slots' second sum), and ``core_vjp=True``
with ``acc_materialize_budget=0``, which takes the same scans; the
hand-written ``core_rnn_sum`` is not reached.
"""
import pytest

from ctgcn_torch.ops import rnn as TR
from tests.test_torch_remat import (assert_matches, jax_model, jax_reference,
                                    pin_jax, port_model, windows)  # noqa: F401

BUDGET = 512 << 20


#: (core_vjp, acc_materialize_budget, core_rnn_budget) -> the tail taken
SETTINGS = {"scan": (False, 8 << 30, BUDGET),
            "scan_acc": (False, 8 << 30, 0),
            "scan_fused": (False, 0, 0),
            "cvjp_no_acc": (True, 0, BUDGET),
            "cvjp_no_acc_over": (True, 0, 0)}


@pytest.mark.parametrize("setting, backend, rnn_type", [
    ("scan", "blocks", "GRU"), ("scan_acc", "blocks", "GRU"),
    ("scan_fused", "blocks", "GRU"), ("scan", "ell_delta", "LSTM"),
    ("scan_acc", "ell_delta", "LSTM"), ("scan_fused", "ell_delta", "LSTM"),
    ("cvjp_no_acc", "ell_delta", "LSTM"),
    ("cvjp_no_acc_over", "ell_delta", "GRU")])
def test_scan_tails_equal_jax(windows, monkeypatch, setting, backend,
                              rnn_type):
    core_vjp, amb, crb = SETTINGS[setting]
    tpyr, jpyr = windows[backend]
    pin_jax(monkeypatch, CTGCN_TPU_CORE_VJP=int(core_vjp),
            CTGCN_TPU_ACC_MATERIALIZE_BUDGET=amb,
            CTGCN_TPU_CORE_RNN_BUDGET=crb)
    jmodel = jax_model("CTGCN", rnn_type)
    ref = jax_reference(jmodel, jpyr)
    model = port_model("CTGCN", jmodel, rnn_type, core_vjp=core_vjp,
                       acc_materialize_budget=amb, core_rnn_budget=crb)
    monkeypatch.setattr(TR._CoreRnnSum, "apply", None)   # not reached
    assert_matches(model, tpyr, ref)
