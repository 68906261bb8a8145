# coding: utf-8
"""The zoo under the supervised learning types against ``ctgcn_tpu`` on the
CPU, on ``tests/test_torch_pgnn.py``'s labelled dataset (N = 64 named
nodes, four of them isolated, three weighted snapshots, node and edge
labels), each method's ``configs/america-air.json`` entry at test width.

  * Every zoo method's supervised forward and loss under S-node (dropout
    0, duration 2), the trainer's inputs captured from both drivers, the
    JAX parameters carried over: logits within 1e-5 of the largest JAX
    logit, loss within 1e-5 of the JAX loss.  What the JAX forward draws
    without a key is given to the port: PGNN's anchor sets and VGRNN's
    noise from ``key(0)``; TgSAGE samples every neighbour
    (``num_sample`` above the largest degree).  VGRNN's forward starts from
    the zero state and its new h is compared too.
  * VGRNN's stateful supervised run: 3 epochs of the port's
    ``SupervisedEmbedding`` against the JAX engine's ``learn_embedding``
    (each epoch's train noise from the JAX engine's epoch key, the
    validation and test forwards' from ``key(0)``): train losses,
    validation accuracies and the test loss within 1e-4, the exported
    embeddings (the test forward's) within 1e-4; on the port's side, the
    state flow: zeros into each train step, the train step's h into the
    validation forward, the best epoch's post-validation h into the test
    forward.
  * The CLI trains every zoo method under S-link-st, and under S-edge,
    S-link-dy and S-node a method each besides: finite losses, test
    accuracy and AUC in [0, 1], one CSV per snapshot.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from ctgcn_torch import main as cli
from ctgcn_torch.nn.pgnn import anchor_sizes
from ctgcn_torch.training import driver as TD
from ctgcn_torch.training.engine import SupervisedEmbedding
from ctgcn_tpu.training import engine as JE
from tests.test_torch_pgnn import (EMB, HID, LN, LT, ROOT,
                                   _jax_window_anchor_sets,
                                   labelled)  # noqa: F401
from tests.test_torch_supervised import _jax_window, _port_window, _state
from tests.test_torch_vgrnn import _noise

TOL = 1e-5
ZOO = ("GCN", "TgGCN", "GIN", "TgGIN", "GAT", "TgGAT", "SAGE", "TgSAGE",
       "GCRN", "EvolveGCN", "VGRNN", "PGNN")


def _config(base, method, lt, **change):
    """``configs/america-air.json``'s ``method`` entry on ``base``, under
    ``lt``, at test width (hid 12, embed 6, classifier hidden 8), 2
    epochs."""
    with open(ROOT / "configs" / "america-air.json") as fp:
        cfg = dict(json.load(fp)["embedding"][method])
    cfg.update(base_path=str(base), learning_type=lt, hid_dim=HID,
               embed_dim=EMB, cls_hid_dim=8, epoch=2, seed=0,
               record_time=False, elabel_folder="edges_label",
               embed_folder=f"2.embedding/{method}-{lt}",
               model_file=f"{method}-{lt}")
    if "feature_dim" in cfg:
        cfg["feature_dim"] = 8
    cfg.update(change)
    return cfg


def _load_jax_params(trainer, jw):
    trainer.model.load_state_dict(_state(jw["model"]))
    if jw["classifier"] is not None:
        trainer.classifier.load_state_dict(_state(jw["classifier"]))


def _given_draws(method, trainer, lt, T):
    """The port's forward_fn with the draws of the JAX forward without a
    key given: PGNN's anchor sets, VGRNN's noise (both from ``key(0)``)."""
    if method == "PGNN":
        return TD._supervised_forward(
            functools.partial(TD._pgnn_forward,
                              anchor_sets=_jax_window_anchor_sets(LN, T)),
            lt, False)
    if method == "VGRNN":
        return TD._vgrnn_supervised_forward(
            functools.partial(TD._vgrnn_forward,
                              noise=_noise(jax.random.key(0), LN, T, EMB)),
            lt)
    return trainer.forward_fn


@pytest.mark.parametrize("method", ZOO)
def test_supervised_forward_and_loss_equal_jax(labelled, monkeypatch,
                                               method):
    base, _ = labelled
    cfg = _config(base, method, "S-node", duration=2, dropout=0.0,
                  num_sample=1000 if method == "TgSAGE" else
                  _config(base, method, "S-node").get("num_sample"))
    jw = _jax_window(monkeypatch, cfg, method)
    trainer = _port_window(monkeypatch, cfg, method)
    _load_jax_params(trainer, jw)
    if method == "PGNN":          # the width rule
        assert trainer.classifier.mlp.layers[0].weight.shape[0] == len(
            anchor_sizes(LN))
    jmodels = (jw["model"], jw["classifier"])
    idx, labels, mask = jw["splits"][:3]
    trainer.forward_fn = _given_draws(method, trainer, "S-node", 2)
    with torch.no_grad():
        if method == "VGRNN":
            hx = jw["state_init"](jw["model"], jw["data"])
            jpreds, _, aux, jh = jax.jit(
                lambda m, d, i, h: jw["forward_fn"](m, d, i, None, h))(
                    jmodels, jw["data"], idx, hx)
            loss, acc, preds, h, _ = trainer._run(
                "train", None, trainer.state_init(trainer.model,
                                                  trainer.data))
            jh = np.asarray(jh)
            np.testing.assert_allclose(h.numpy(), jh, rtol=0,
                                       atol=TOL * np.abs(jh).max())
        else:
            jpreds, _, aux = jax.jit(
                lambda m, d, i: jw["forward_fn"](m, d, i, None))(
                    jmodels, jw["data"], idx)
            loss, acc, preds = trainer._run("train")
    jloss, jacc = jw["loss_fn"](jpreds, labels, mask, aux)
    jpreds = np.asarray(jpreds)
    assert preds.shape == jpreds.shape
    np.testing.assert_allclose(preds.numpy(), jpreds, rtol=0,
                               atol=TOL * np.abs(jpreds).max())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    assert acc.item() == pytest.approx(float(jacc), abs=1e-6)


EPOCHS, SEED = 3, 3


def test_vgrnn_stateful_supervised_run_equals_jax(labelled, monkeypatch):
    base, _ = labelled
    cfg = _config(base, "VGRNN", "S-node")
    T = min(cfg["duration"], LT)
    jw = _jax_window(monkeypatch, cfg, "VGRNN")
    trainer = _port_window(monkeypatch, cfg, "VGRNN")
    _load_jax_params(trainer, jw)

    # the JAX engine, each loss and accuracy recorded as it is computed
    record = []

    def recorded_loss(preds, labels, mask, aux):
        loss, acc = jw["loss_fn"](preds, labels, mask, aux)
        jax.debug.callback(lambda l, a: record.append((float(l), float(a))),
                           loss, acc, ordered=True)
        return loss, acc

    kw = {k: v for k, v in jw.items() if k != "splits"}
    kw["loss_fn"] = recorded_loss
    jtrainer = JE.SupervisedEmbedding(**kw)
    jexport = []
    monkeypatch.setattr(jtrainer, "save_embedding",
                        lambda out, start: jexport.append(np.asarray(out)))
    jtrainer.learn_embedding(*jw["splits"], epoch=EPOCHS, lr=cfg["lr"],
                             weight_decay=cfg["weight_decay"],
                             model_file=None, classifier_file=None,
                             seed=SEED, verbose=False)
    jax.effects_barrier()
    # train 1, train 2, val 2, train 3, val 3, test
    assert len(record) == 6
    j_train = [record[i][0] for i in (0, 1, 3)]
    j_val = [record[i][1] for i in (2, 4)]

    # the port, with the JAX engine's noise: epoch e's train step from
    # its epoch key, the other forwards from key(0)
    rng, keys = jax.random.key(SEED), []
    for _ in range(EPOCHS):
        rng, k = jax.random.split(rng)
        keys.append(k)
    train_noise = iter([_noise(k, LN, T, EMB) for k in keys])
    eval_noise = _noise(jax.random.key(0), LN, T, EMB)

    def fwd(m, d, generator=None, hx=None):
        noise = next(train_noise) if generator is not None else eval_noise
        return TD._vgrnn_forward(m, d, hx=hx, noise=noise)

    inner = TD._vgrnn_supervised_forward(fwd, "S-node")
    flow = []

    def spy(model, classifier, data, items, generator, hx):
        out = inner(model, classifier, data, items, generator, hx)
        flow.append((generator is not None, hx, out[2].detach()))
        return out

    trainer.forward_fn = spy
    exported = []
    monkeypatch.setattr(trainer, "save_embedding",
                        lambda out, start: exported.append(out))
    # the captured trainer's own learn_embedding only captures
    res = SupervisedEmbedding.learn_embedding(
        trainer, epoch=EPOCHS, lr=cfg["lr"],
        weight_decay=cfg["weight_decay"], model_file=None,
        classifier_file=None, seed=SEED, verbose=False)
    np.testing.assert_allclose(res["losses"], j_train, rtol=1e-4)
    np.testing.assert_allclose(res["acc_val"], j_val, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["loss_test"], record[5][0], rtol=1e-4)
    np.testing.assert_allclose(exported[0].numpy(), jexport[0], rtol=1e-4,
                               atol=1e-4)
    # the state flow: train steps from zeros, validation from the train
    # step's h, the test from the best epoch's post-validation h
    assert [f[0] for f in flow] == [True, True, False, True, False, False]
    for i in (0, 1, 3):
        assert not flow[i][1].any()
    for v in (2, 4):
        torch.testing.assert_close(flow[v][1], flow[v - 1][2], rtol=0,
                                   atol=0)
    best = 2 if res["acc_val"][0] >= res["acc_val"][1] else 4
    torch.testing.assert_close(flow[5][1], flow[best][2], rtol=0, atol=0)


CLI_CASES = ([(m, "S-link-st") for m in ZOO]
             + [("GCN", "S-edge"), ("PGNN", "S-edge"), ("GAT", "S-link-dy"),
                ("VGRNN", "S-link-dy"), ("EvolveGCN", "S-node")])


@pytest.mark.parametrize("method, lt", CLI_CASES)
def test_cli_runs_the_zoo_supervised(labelled, tmp_path, method, lt):
    """S-link-dy (duration 3 here) skips the last snapshot, which only
    gives edges to predict, so its one window holds 2 snapshots."""
    base, _ = labelled
    dy = lt == "S-link-dy"
    cfg = _config(base, method, lt, **({"duration": LT} if dy else {}))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {method: cfg}}))
    results = cli.main([f"--config={path}", "--task=embedding",
                        f"--method={method}", "--device=cpu"])
    if dy:
        assert [(r["idx"], r["time_length"]) for r in results] == [
            (0, LT - 1)]
    assert sum(r["time_length"] for r in results) == LT - dy
    for r in results:
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert 0.0 <= r["acc_test"] <= 1.0
        assert np.isnan(r["auc_test"]) or 0.0 <= r["auc_test"] <= 1.0
    files = sorted(p.name for p in (base / cfg["embed_folder"]).iterdir())
    assert files == [f"201{t}.csv" for t in range(LT - dy)]
