# coding: utf-8
"""The port's temporal pipeline (``ctgcn_torch/parallel/pipeline.py``,
config ``temporal_pipeline``) on gloo ranks on the CPU, against
``ctgcn_tpu.parallel.pipeline``.

Two spawns of ``tests/_torch_dist_ranks.py`` (``tests/test_torch_dist.py``'s
``_start`` / ``_finish``), inputs made here from numpy seeds:

  * 2 and 4 ranks: ``pipelined_rnn_scan`` of a GRU and an LSTM cell at
    T = 8, N = 32 (K = ``pick_microbatch(32, P)``) against the JAX
    ``pipelined_rnn_scan`` on ``make_mesh(P, axis_name="stage")`` over the
    8 virtual CPU devices: outputs within 1e-5 relative, the cell's and
    xs's gradients within 1e-4; ``ctgcn_pipelined_forward`` of CTGCN-C
    (GRU) and CTGCN-S (LSTM) the same way, every parameter's gradient
    assembled over the parts by the pipeline's rule (the time RNN and the
    norm summed);
  * 2 ranks: one ``temporal_pipeline`` train step of CTGCN-C (U-neg, the
    JAX sampler's draws) at T = 4 against the JAX single-device step with
    the same parameters: the loss (1e-5), every assembled gradient (1e-4)
    and the parameters after one Adam step (1e-6); and the CLI, CTGCN-C
    U-neg with ``n_devices: 2`` and ``temporal_pipeline: true``, against
    the port's single-device run: CSVs within 1e-5, the model file's keys
    in order and its values within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctgcn_torch.parallel.pipeline import pick_microbatch
from ctgcn_torch.training.engine import read_model_file
from ctgcn_tpu.nn.core_models import CTGCN as JCTGCN
from ctgcn_tpu.ops.pyramid import build_core_pyramid, stack_pyramids
from ctgcn_tpu.ops.rnn import GRUCell as JGRUCell
from ctgcn_tpu.ops.rnn import LSTMCell as JLSTMCell
from ctgcn_tpu.parallel import pipeline as JP
from ctgcn_tpu.parallel.mesh import make_mesh
from tests.test_torch_dist import (_close, _core_mats, _csvs, _finish,
                                   _graph, _jax_out_grad, _start, _state,
                                   _time_case, cli_data)  # noqa: F401

T, N, D, H = 8, 32, 6, 5
CELLS = {"GRU": JGRUCell, "LSTM": JLSTMCell}
MODELS = {"CTGCN-C": dict(trans_num=1, model_type="C", rnn_type="GRU"),
          "CTGCN-S": dict(trans_num=2, model_type="S", rnn_type="LSTM",
                          trans_activate_type="N")}
FIELDS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _pipeline_case(world):
    """The ranks' inputs, and a function that computes the JAX references
    of the scans and of the pipelined CTGCN forwards on a ``world``-stage
    mesh (called while the ranks run)."""
    rng = np.random.default_rng(world)
    xs = rng.standard_normal((T, N, D)).astype(np.float32)
    w = rng.standard_normal((T, N, H)).astype(np.float32)
    k = pick_microbatch(N, world)
    assert k == JP.pick_microbatch(N, world)
    cells = {rnn_type: cls.init(jax.random.key(i), D, H)
             for i, (rnn_type, cls) in enumerate(CELLS.items())}
    mats = [_core_mats(_graph(rng, N, density=0.2), levels=(4, 2, 1))
            for _ in range(T)]
    models = {}
    for i, (name, kw) in enumerate(MODELS.items()):
        kw = dict(kw, diffusion_num=2, duration=T)
        models[name] = (JCTGCN.init(jax.random.key(10 + i), N, 10, H, **kw),
                        kw, rng.standard_normal((T, N, H)).astype(
                            np.float32))
    inp = {"xs": xs, "w": w, "K": k,
           "cells": {t: {f: np.asarray(getattr(c, f)) for f in FIELDS}
                     for t, c in cells.items()},
           "models": {name: {"dims": (N, 10, H), "kw": kw,
                             "state": _state(model), "mats": mats, "n": N,
                             "w": ws}
                      for name, (model, kw, ws) in models.items()}}

    def reference():
        mesh = make_mesh(world, axis_name="stage")
        ref = {}
        for rnn_type, cell in cells.items():
            y, (gc, gx) = _jax_out_grad(
                lambda c, x: JP.pipelined_rnn_scan(
                    mesh, c, x, axis="stage", n_microbatch=k),
                lambda y: jnp.sum(jnp.tanh(y) * w), cell, jnp.asarray(xs),
                argnums=(0, 1))
            ref[rnn_type] = {"y": np.asarray(y), "dx": np.asarray(gx),
                             "grads": {f: np.asarray(getattr(gc, f))
                                       for f in FIELDS}}
        kk = max(len(m) for m in mats)
        jpyr = stack_pyramids([build_core_pyramid(m, N, num_slots=kk,
                                                  pad_to=N * N)
                               for m in mats])
        for name, (model, _, ws) in models.items():
            def core_loss(res, ws=ws):
                if isinstance(res, tuple):
                    return (jnp.sum(jnp.tanh(res[0]) * ws)
                            + 0.5 * jnp.sum(jnp.square(res[1])))
                return jnp.sum(jnp.tanh(res) * ws)

            res, grads = _jax_out_grad(
                lambda m: JP.ctgcn_pipelined_forward(mesh, m, None, jpyr,
                                                     axis="stage"),
                core_loss, model)
            embs, trans = res if isinstance(res, tuple) else (res, None)
            ref[name] = {"embs": np.asarray(embs), "grads": _state(grads),
                         "trans": None if trans is None
                         else np.asarray(trans)}
        return ref

    return inp, reference


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    inp, reference = _pipeline_case(4)
    workdir = tmp_path_factory.mktemp("pipe4")
    started = _start(4, workdir, ("pipeline",), {"pipeline": inp})
    ref = reference()
    return _finish(started, 4, workdir, ("pipeline",))["pipeline"], ref


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, cli_data):
    _, config, _ = cli_data
    pipe_inp, pipe_reference = _pipeline_case(2)
    case, reference = _time_case("C", 21)
    case["pipeline"] = True
    inputs = {"pipeline": pipe_inp,
              "time": {"cases": {"CTGCN-C": case}},
              "cli": {"method": "CTGCN-C", "configs": {
                  "pipe2": config("pipe2", n_devices=2,
                                  temporal_pipeline=True)}}}
    jobs = ("pipeline", "time", "cli")
    workdir = tmp_path_factory.mktemp("pipe2")
    started = _start(2, workdir, jobs, inputs)
    refs = {"pipeline": pipe_reference(), "step": reference()}
    return _finish(started, 2, workdir, jobs), refs


def _ranks(request, world):
    if world == 4:
        return request.getfixturevalue("four_ranks")
    out, refs = request.getfixturevalue("two_ranks")
    return out["pipeline"], refs["pipeline"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_pipelined_rnn_scan_equals_jax(request, world, rnn_type):
    got, ref = _ranks(request, world)
    got, ref = got[rnn_type], ref[rnn_type]
    assert got["y"].shape == (T, N, H)
    _close(got["y"], ref["y"], name="y")
    _close(got["dx"], ref["dx"], rtol=1e-4, name="dx")
    for f in FIELDS:
        _close(got["grads"][f], ref["grads"][f], rtol=1e-4, name=f)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_ctgcn_pipelined_forward_equals_jax(request, world, name):
    got, ref = _ranks(request, world)
    got, ref = got[name], ref[name]
    _close(got["embs"], ref["embs"], name="embs")
    if ref["trans"] is not None:
        _close(got["trans"], ref["trans"], name="trans")
    assert set(got["grads"]) == set(ref["grads"])
    for k, v in ref["grads"].items():
        _close(got["grads"][k], v, rtol=1e-4, name=k)


def test_pipeline_train_step_equals_jax(two_ranks):
    """One ``temporal_pipeline`` step of CTGCN-C U-neg on 2 ranks: the
    loss, the gradients the pipeline's rule assembles (the time RNN's and
    the norm's summed over the parts) and the parameters after Adam."""
    out, refs = two_ranks
    got, ref = out["time"]["CTGCN-C"], refs["step"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["own"] == [0, 2]
    assert list(got["grads"]) == list(got["params"])
    assert set(got["grads"]) == set(ref["grads"])
    for k, v in ref["grads"].items():
        _close(got["grads"][k], v, rtol=1e-4, name=f"grad {k}")
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_cli_pipeline_on_two_ranks_equals_one_device(two_ranks, cli_data):
    """``n_devices: 2`` with ``temporal_pipeline: true`` (T = 4: two
    stages) exports what one device exports."""
    out, _ = two_ranks
    base, _, single = cli_data
    res = out["cli"]["pipe2"]
    assert [(r["parts"], r["core_backend"]) for r in res] == [(2, "blocks")]
    np.testing.assert_allclose(res[0]["losses"], single[0]["losses"],
                               rtol=1e-5)
    got, ref = (_csvs(base / "2.embedding" / t) for t in ("pipe2", "single"))
    assert list(got) == list(ref) and len(ref) == 4
    for f in ref:
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    model_dir = base / "CTGCN" / "model"
    got = read_model_file(model_dir / "pipe2")
    ref = read_model_file(model_dir / "single")
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
