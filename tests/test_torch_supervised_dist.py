# coding: utf-8
"""The supervised learning types over several parts on gloo ranks on the
CPU, against ``ctgcn_tpu`` and against the port's single-device runs.

One spawn of 2 ranks of ``tests/_torch_dist_ranks.py``
(``tests/test_torch_dist.py``'s ``_start`` / ``_finish``) on
``tests/test_torch_supervised.py``'s labelled dataset (N = 60, four
weighted snapshots, node and edge labels, k-core pyramids), each method's
``configs/america-air.json`` entry at test width:

  * CTGCN-C under S-node (T = 4) and S-link-dy (T = 2), time-sharded; GCN
    under S-node on the halo path (``graph_partition``); VGRNN under
    S-link-st, stateful, on one part (rank 1 holds none); PGNN under
    S-node, time-sharded: the train forward of window 0 through the
    driver's layout, the JAX parameters loaded, against the JAX driver's
    supervised objective (the trainer's inputs captured from the JAX
    driver, dropout 0, PGNN's anchor sets and VGRNN's noise given from
    ``key(0)`` as the JAX forward draws them without a key): the loss
    and the accuracy (1e-5), the model's gradients, assembled over the
    parts, and the classifier's (1e-4, atol 1e-5), and both modules'
    parameters after one Adam step (1e-6);
  * the CLI under each of those configs (as written: their dropout), 3
    epochs, with ``n_devices: 2`` against the port's single-device run:
    the same validation accuracies, best epoch and test accuracy, the
    CSVs within 1e-5, and the model and classifier files' keys in order
    with their values within 1e-5.
"""
import json

import jax
import numpy as np
import optax
import pytest
import torch

from ctgcn_torch import main as cli
from ctgcn_torch.training.engine import read_model_file
from ctgcn_tpu.training.engine import make_optimizer as j_make_optimizer
from tests.test_torch_dist import ROOT, _finish, _start
from tests.test_torch_pgnn import _jax_window_anchor_sets
from tests.test_torch_supervised import (N, SNAPS, _jax_window, _state,
                                         dataset)  # noqa: F401
from tests.test_torch_vgrnn import _noise

EMB = 6
LR, WD = 1e-3, 5e-4
#: name -> (method, learning type, config changes)
CASES = {
    "ctgcn_snode": ("CTGCN-C", "S-node", dict(duration=SNAPS)),
    "ctgcn_slink_dy": ("CTGCN-C", "S-link-dy", dict(duration=2)),
    "gcn_snode_halo": ("GCN", "S-node", dict(graph_partition=True)),
    "vgrnn_slink_st": ("VGRNN", "S-link-st", dict(duration=SNAPS)),
    "pgnn_snode": ("PGNN", "S-node", dict(duration=SNAPS)),
}
#: (kind, parts) of window 0 of each case
LAYOUTS = {"ctgcn_snode": ("time", 2), "ctgcn_slink_dy": ("time", 2),
           "gcn_snode_halo": ("graph", 2), "vgrnn_slink_st": (None, 1),
           "pgnn_snode": ("time", 2)}


def _config(base, name, **change):
    method, lt, extra = CASES[name]
    with open(ROOT / "configs" / "america-air.json") as fp:
        cfg = dict(json.load(fp)["embedding"][method])
    cfg.update(base_path=str(base), core_folder="cores", learning_type=lt,
               hid_dim=12, embed_dim=EMB, cls_hid_dim=8, epoch=3, seed=5,
               record_time=False, elabel_folder="edges_label",
               embed_folder=f"2.embedding/{name}", model_file=name,
               cls_file=f"{name}_cls", n_devices=2, **extra)
    if "feature_dim" in cfg:
        cfg["feature_dim"] = 8
    cfg.update(change)
    return cfg


def _jax_case(base, name):
    """The ranks' inputs of a case's train forward, and a function that
    computes the JAX objective and its gradients."""
    method = CASES[name][0]
    cfg = _config(base, name, dropout=0.0)
    with pytest.MonkeyPatch.context() as mp:
        jcfg = {k: v for k, v in cfg.items()
                if k not in ("n_devices", "graph_partition")}
        jw = _jax_window(mp, jcfg, method)
    case = {"method": method, "config": cfg, "state": _np(jw["model"]),
            "cls_state": (None if jw["classifier"] is None
                          else _np(jw["classifier"])), "lr": LR, "wd": WD}
    T = jw["time_length"]
    if method == "PGNN":
        case["anchors"] = [[a.numpy() for a in sets]
                           for sets in _jax_window_anchor_sets(N, T)]
    if method == "VGRNN":
        case["noise"] = [z.numpy() for z in _noise(jax.random.key(0), N, T,
                                                   EMB)]

    def reference():
        idx, labels, mask = jw["splits"][:3]
        stateful = jw.get("state_init") is not None

        def objective(models):
            if stateful:
                hx = jw["state_init"](models[0], jw["data"])
                preds, _, aux, _ = jw["forward_fn"](models, jw["data"], idx,
                                                    None, hx)
            else:
                preds, _, aux = jw["forward_fn"](models, jw["data"], idx,
                                                 None)
            return jw["loss_fn"](preds, labels, mask, aux)

        models = (jw["model"], jw["classifier"])
        (loss, acc), grads = jax.jit(jax.value_and_grad(
            objective, has_aux=True))(models)
        opt = j_make_optimizer(LR, WD)
        upd, _ = opt.update(grads, opt.init(models), models)
        new = optax.apply_updates(models, upd)
        return {"loss": float(loss), "acc": float(acc),
                "grads": _np(grads[0]),
                "cls_grads": None if grads[1] is None else _np(grads[1]),
                "params": _np(new[0]),
                "cls_params": None if new[1] is None else _np(new[1])}

    return case, reference


def _np(tree):
    return {k: v.numpy() for k, v in _state(tree).items()}


def _csvs(folder):
    """Every embedding CSV of a folder: its values, the index column
    dropped."""
    return {p.name: np.array([[float(v) for v in row.split("\t")[1:]]
                              for row in p.read_text().splitlines()[1:]])
            for p in sorted(folder.iterdir())}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, dataset):
    base, _ = dataset
    cases, refs = {}, {}
    for name in CASES:
        cases[name], refs[name] = _jax_case(base, name)
    configs = {}
    for name in CASES:
        path = base / f"{name}.json"
        path.write_text(json.dumps({"embedding": {
            CASES[name][0]: _config(base, name)}}))
        configs[name] = str(path)
    inputs = {"supervised_step": {"cases": cases},
              "cli": {"methods": {n: c[0] for n, c in CASES.items()},
                      "configs": configs}}
    jobs = ("supervised_step", "cli")
    workdir = tmp_path_factory.mktemp("sup2")
    started = _start(2, workdir, jobs, inputs)
    refs = {name: reference() for name, reference in refs.items()}
    single = {}
    for name, (method, _, _) in CASES.items():
        path = base / f"{name}-one.json"
        path.write_text(json.dumps({"embedding": {method: _config(
            base, name, n_devices=1, embed_folder=f"2.embedding/{name}-one",
            model_file=f"{name}-one", cls_file=f"{name}-one_cls")}}))
        single[name] = cli.main([f"--config={path}", "--task=embedding",
                                 f"--method={method}", "--device=cpu"])
    return _finish(started, 2, workdir, jobs), refs, single


def test_adam_moves_a_parameter_no_loss_reached_as_optax_does():
    """optax updates every leaf: a parameter without a gradient (PGNN's
    first position head, whose output no loss reads) moves by its weight
    decay through Adam, on one part as on several, where the gradient
    all-reduce gives it zeros."""
    from ctgcn_torch.training.engine import make_optimizer

    rng = np.random.default_rng(1)
    used, unused = (rng.standard_normal(5).astype(np.float32)
                    for _ in range(2))
    params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
              for v in (used, unused)]
    opt = make_optimizer(params, LR, WD)
    (params[0] ** 2).sum().backward()
    assert params[1].grad is None
    opt.step()
    tree = {"used": used, "unused": unused}
    jopt = j_make_optimizer(LR, WD)
    upd, _ = jopt.update({"used": 2 * used, "unused": 0 * unused},
                         jopt.init(tree), tree)
    ref = optax.apply_updates(tree, upd)
    for p, k in zip(params, ("used", "unused")):
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_supervised_step_over_two_parts_equals_jax(two_ranks, name):
    out, refs, _ = two_ranks
    got, ref = out["supervised_step"][name], refs[name]
    assert (got["kind"], got["parts"]) == LAYOUTS[name]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], ref["acc"], rtol=1e-5)
    for key in ("grads", "cls_grads", "params", "cls_params"):
        if ref[key] is None:
            assert got[key] is None
            continue
        assert set(got[key]) == set(ref[key])
        tol = (dict(rtol=1e-6, atol=1e-6) if key.endswith("params")
               else dict(rtol=1e-4, atol=1e-5))
        for k, v in ref[key].items():
            np.testing.assert_allclose(got[key][k], v, err_msg=f"{key} {k}",
                                       **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_cli_supervised_on_two_ranks_equals_one_device(two_ranks, dataset,
                                                       name):
    out, _, single = two_ranks
    base, _ = dataset
    res, ref = out["cli"][name], single[name]
    assert res[0]["parts"] == LAYOUTS[name][1]
    assert [r["idx"] for r in res] == [r["idx"] for r in ref]
    for got, want in zip(res, ref):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["acc_val"], want["acc_val"],
                                   rtol=1e-6)
        assert int(np.argmax(got["acc_val"])) == int(np.argmax(
            want["acc_val"]))
        # (nan on both sides where a window's splits are empty)
        for key in ("best_acc_val", "acc_test"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-6, err_msg=key)
    got, want = (_csvs(base / "2.embedding" / t) for t in (name,
                                                          name + "-one"))
    assert list(got) == list(want) and want
    for f in want:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    # the model file and the classifier's (none for the link types)
    model_dir = base / _config(base, name)["model_folder"]
    for got_f, want_f in ((name, f"{name}-one"),
                          (f"{name}_cls", f"{name}-one_cls")):
        assert (model_dir / got_f).is_file() == (
            model_dir / want_f).is_file()
        if not (model_dir / want_f).is_file():
            assert CASES[name][1].startswith("S-link")
            continue
        got, want = (read_model_file(model_dir / f)
                     for f in (got_f, want_f))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
