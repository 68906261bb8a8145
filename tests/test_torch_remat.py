# coding: utf-8
"""``remat_policy: "save_spmm"`` against ``ctgcn_tpu``: with
``act_budget=0`` every timestep is over the budget, so the backward
recomputes; under "save_spmm" only the stages between the SpMMs (the MLP
and each CoreDiffusion layer's tail), keeping the slot products.

  * CTGCN-C (and CGCN-C on one backend) forward and every parameter
    gradient against the JAX model with ``CTGCN_TPU_ACT_BUDGET=0`` and
    ``CTGCN_TPU_REMAT_POLICY=save_spmm``, ``layer_remat`` off and on
    (``CTGCN_TPU_LAYER_REMAT``), on the ELL (delta), pallas (BSR plans,
    the JAX kernels in interpret mode) and blocks backends: values within
    1e-5, gradients within 1e-4 (of the largest gradient of the
    parameter);
  * the backward runs no forward SpMM under "save_spmm" and does under
    "full": the plain SpMM's calls on a forward plan ([K·N, N]), or the
    blocks' bank GEMMs, counted while ``backward`` runs;
  * ``driver.core_knobs``: the config's keys, else the variables, else the
    defaults; an unknown policy raises.

The JAX package reads its variables while it traces, so each setting is
pinned both ways with ``monkeypatch.setenv`` and ``jax.clear_caches()``
runs between settings.  The window is ``tests/test_torch_backends.py``'s
(N = 64, T = 2, K = 4, hid 8, embed 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import core_models as TM
from ctgcn_torch.ops import bsr_spmm as TB
from ctgcn_torch.training import driver as TD
from ctgcn_tpu.nn import core_models as JM
from tests.test_torch_backends import EMB, HID, N, T, WEIGHT, _build, _window

VAL_TOL, GRAD_TOL = 1e-5, 1e-4
BACKENDS = ("ell_delta", "pallas", "blocks")
#: the JAX package's variables a test may set; each is pinned
JAX_VARS = ("CTGCN_TPU_ACT_BUDGET", "CTGCN_TPU_REMAT_POLICY",
            "CTGCN_TPU_LAYER_REMAT", "CTGCN_TPU_BATCH_WINDOW_TAIL",
            "CTGCN_TPU_CORE_VJP", "CTGCN_TPU_ACC_MATERIALIZE_BUDGET",
            "CTGCN_TPU_CORE_RNN_BUDGET", "CTGCN_TPU_CVJP_BATCH_BUDGET")


def pin_jax(monkeypatch, **values):
    """Every variable of ``JAX_VARS`` set to ``values``' entry (its JAX
    default otherwise), and JAX's compiled traces dropped."""
    defaults = {"CTGCN_TPU_ACT_BUDGET": str(4 << 30),
                "CTGCN_TPU_REMAT_POLICY": "full",
                "CTGCN_TPU_LAYER_REMAT": "0",
                "CTGCN_TPU_BATCH_WINDOW_TAIL": "0",
                "CTGCN_TPU_CORE_VJP": "1",
                "CTGCN_TPU_ACC_MATERIALIZE_BUDGET": str(8 << 30),
                "CTGCN_TPU_CORE_RNN_BUDGET": str(512 << 20),
                "CTGCN_TPU_CVJP_BATCH_BUDGET": str(512 << 20)}
    for name in JAX_VARS:
        monkeypatch.setenv(name, str(values.get(name, defaults[name])))
    jax.clear_caches()


@pytest.fixture(scope="module")
def windows():
    per_snap = _window()
    return {b: _build(b, per_snap) for b in BACKENDS}


def jax_model(kind, rnn_type="GRU", key=0):
    if kind == "CTGCN":
        return JM.CTGCN.init(jax.random.key(key), N, HID, EMB, trans_num=1,
                             diffusion_num=2, duration=T, rnn_type=rnn_type)
    return JM.CGCN.init(jax.random.key(key), N, HID, EMB, trans_num=1,
                        diffusion_num=2, rnn_type=rnn_type)


def port_model(kind, jmodel, rnn_type="GRU", **knobs):
    cls = TM.CTGCN if kind == "CTGCN" else TM.CGCN
    extra = {"duration": T} if kind == "CTGCN" else {}
    model = cls(N, HID, EMB, trans_num=1, diffusion_num=2,
                rnn_type=rnn_type, **extra, **knobs)
    model.load_state_dict(params_from_numpy(jax.tree.map(
        np.asarray, serialization.to_state_dict(jmodel))))
    return model


def jax_reference(jmodel, jpyr):
    """(loss, output, gradients as a port state_dict) of
    sum(tanh(out) * WEIGHT), traced under the variables set now."""
    def loss(m):
        out = m(None, jpyr)
        return jnp.sum(jnp.tanh(out) * jnp.asarray(WEIGHT)), out

    (val, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jmodel)
    return float(val), np.asarray(out), params_from_numpy(jax.tree.map(
        np.asarray, serialization.to_state_dict(grads)))


def port_loss(model, tpyr):
    out = model(None, tpyr)
    return (torch.tanh(out) * torch.from_numpy(WEIGHT)).sum(), out


def assert_matches(model, tpyr, ref):
    """The port's loss, output and gradients against ``ref``."""
    jval, jout, jgrads = ref
    loss, out = port_loss(model, tpyr)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=VAL_TOL,
                               atol=VAL_TOL * np.abs(jout).max())
    np.testing.assert_allclose(loss.item(), jval, rtol=VAL_TOL)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=GRAD_TOL,
            atol=GRAD_TOL * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("layer_remat", [False, True],
                         ids=["layers", "layer_remat"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_save_spmm_equals_jax(windows, monkeypatch, backend, layer_remat):
    tpyr, jpyr = windows[backend]
    pin_jax(monkeypatch, CTGCN_TPU_ACT_BUDGET=0,
            CTGCN_TPU_REMAT_POLICY="save_spmm",
            CTGCN_TPU_LAYER_REMAT=int(layer_remat))
    jmodel = jax_model("CTGCN")
    ref = jax_reference(jmodel, jpyr)
    model = port_model("CTGCN", jmodel, act_budget=0,
                       remat_policy="save_spmm", layer_remat=layer_remat)
    assert_matches(model, tpyr, ref)


def test_save_spmm_cgcn_equals_jax(windows, monkeypatch):
    tpyr, jpyr = windows["ell_delta"]
    pin_jax(monkeypatch, CTGCN_TPU_ACT_BUDGET=0,
            CTGCN_TPU_REMAT_POLICY="save_spmm")
    jmodel = jax_model("CGCN", key=1)
    ref = jax_reference(jmodel, jpyr)
    assert_matches(port_model("CGCN", jmodel, act_budget=0,
                              remat_policy="save_spmm"), tpyr, ref)


def _backward_spmms(monkeypatch, model, tpyr):
    """(forward SpMMs in the forward, forward SpMMs in the backward): the
    plain SpMM's calls on a forward plan ([K·N, N] rows over columns),
    and on the blocks backend the bank GEMMs."""
    counts = {"forward": 0, "backward": 0}
    phase = ["forward"]
    plain, bank_mm = TB.bsr_spmm_csr_plain, TM._bank_mm

    def counted_plain(plan, x, vals=None):
        if plan.n_rows > plan.n_cols:
            counts[phase[0]] += 1
        return plain(plan, x, vals)

    def counted_bank(a, b, prec):
        counts[phase[0]] += 1
        return bank_mm(a, b, prec)

    monkeypatch.setattr(TB, "bsr_spmm_csr_plain", counted_plain)
    monkeypatch.setattr(TM, "_bank_mm", counted_bank)
    loss, _ = port_loss(model, tpyr)
    phase[0] = "backward"
    loss.backward()
    return counts["forward"], counts["backward"]


@pytest.mark.parametrize("layer_remat", [False, True],
                         ids=["layers", "layer_remat"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_save_spmm_runs_no_forward_spmm_in_the_backward(
        windows, monkeypatch, backend, layer_remat):
    tpyr, _ = windows[backend]
    jmodel = jax_model("CTGCN")
    runs = {}
    for policy in ("full", "save_spmm"):
        model = port_model("CTGCN", jmodel, act_budget=0,
                           remat_policy=policy, layer_remat=layer_remat)
        runs[policy] = _backward_spmms(monkeypatch, model, tpyr)
        monkeypatch.undo()
    # every snapshot's two layers run their products once a forward
    fwd = T * 2 * (1 if backend != "blocks" else 3)
    assert runs["save_spmm"] == (fwd, 0)
    assert runs["full"][0] == fwd and runs["full"][1] >= fwd


def test_core_knobs_read_the_config_then_the_variables(monkeypatch):
    for name in JAX_VARS:
        monkeypatch.delenv(name, raising=False)
    knobs = TD.core_knobs({})
    assert knobs == dict(
        act_budget=TM.ACT_BUDGET, remat_policy="full", layer_remat=False,
        cvjp_batch_budget=512 << 20, core_rnn_budget=TM.CORE_RNN_BUDGET,
        core_vjp=True, acc_materialize_budget=TM.ACC_MATERIALIZE_BUDGET,
        batch_window_tail=False)
    env = {"CTGCN_TPU_ACT_BUDGET": "0", "CTGCN_TPU_REMAT_POLICY": "save_spmm",
           "CTGCN_TPU_LAYER_REMAT": "1", "CTGCN_TPU_CVJP_BATCH_BUDGET": "7",
           "CTGCN_TPU_CORE_RNN_BUDGET": "8", "CTGCN_TPU_CORE_VJP": "0",
           "CTGCN_TPU_ACC_MATERIALIZE_BUDGET": "9",
           "CTGCN_TPU_BATCH_WINDOW_TAIL": "1"}
    assert TD.core_knobs({}, env) == dict(
        act_budget=0, remat_policy="save_spmm", layer_remat=True,
        cvjp_batch_budget=7, core_rnn_budget=8, core_vjp=False,
        acc_materialize_budget=9, batch_window_tail=True)
    # the config's keys first; a false layer_remat leaves the variable's
    assert TD.core_knobs({"remat_policy": "full", "layer_remat": False},
                         env)["remat_policy"] == "full"
    assert TD.core_knobs({"layer_remat": False}, env)["layer_remat"]
    assert TD.core_knobs({"layer_remat": True})["layer_remat"]
    with pytest.raises(ValueError, match="remat_policy 'some'"):
        TD.core_knobs({"remat_policy": "some"})
    with pytest.raises(ValueError, match="remat_policy"):
        TM.CGCN(N, HID, EMB, 1, 2, remat_policy="spmm")
