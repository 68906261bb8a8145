# coding: utf-8
"""The supervised learning types of the port against ``ctgcn_tpu``, on the
CPU at small sizes (inputs from numpy seeds):

  * ``classification_loss``, binary and multiclass, with and without a
    mask: loss and accuracy within 1e-6;
  * ``MLPClassifier``, ``inner_product`` and ``EdgeClassifier`` with the
    JAX heads' parameters (``params_from_numpy``): within 1e-6;
  * the label and edge loaders, ``build_label_splits``, and
    ``build_link_splits`` (st and dy) under ``np.random.seed(s)`` on the
    JAX side and ``RandomState(s)`` in the port: bit-equal;
  * the binary and multiclass AUC helpers against the JAX package's
    sklearn ones: within 1e-12;
  * one supervised window through each package's driver (the JAX
    trainer's and the port's inputs captured before training) for CTGCN-C
    under S-node, S-edge, S-link-st and S-link-dy and CTGCN-S under
    S-link-st, on the blocks and delta-ELL backends: the same splits and
    features, and with the JAX parameters, logits within 1e-5, loss and
    accuracy within 1e-5 relative, every gradient of the model and the
    classifier within rtol 1e-4 + atol 1e-5;
  * the best-on-validation parameters are copies: a run whose validation
    accuracy peaks at epoch 2 of 3 saves, tests and exports epoch 2's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ctgcn_torch import losses as TL
from ctgcn_torch.data.formats import read_embedding_csv
from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import heads as TH
from ctgcn_torch.training import driver as tdriver
from ctgcn_torch.training import splits as TS
from ctgcn_torch.training.engine import (SupervisedEmbedding,
                                         read_model_file)
from ctgcn_tpu import losses as JL
from ctgcn_tpu.data.loader import DataLoader as JDataLoader
from ctgcn_tpu.nn import heads as JH
from ctgcn_tpu.training import driver as jdriver

N, SNAPS, CLASSES = 60, 4, 3


def _state(tree):
    return params_from_numpy(jax.tree.map(
        np.asarray, serialization.to_state_dict(tree)))


# --------------------------------------------------------------- the loss

@pytest.mark.parametrize("binary", [True, False], ids=["binary", "multi"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_classification_loss_equals_jax(binary, masked):
    rng = np.random.default_rng(1)
    T, B, C = 3, 40, 5
    preds = (rng.standard_normal((T, B) if binary else (T, B, C)) * 3
             ).astype(np.float32)
    labels = (rng.integers(0, 2, (T, B)).astype(np.float32) if binary
              else rng.integers(0, C, (T, B)))
    mask = rng.random((T, B)) < 0.7 if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    jloss, jacc = JL.classification_loss(jnp.asarray(preds),
                                         jnp.asarray(labels), C, mask=mask_j)
    tloss, tacc = TL.classification_loss(torch.from_numpy(preds),
                                         torch.from_numpy(labels),
                                         mask=mask_t)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(tacc.item(), float(jacc), rtol=1e-6)


# -------------------------------------------------------------- the heads

@pytest.mark.parametrize("layers, act", [(1, "L"), (2, "N")])
def test_heads_equal_jax(layers, act):
    rng = np.random.default_rng(2)
    T, d, B = 3, 6, 17
    x = rng.standard_normal((T, N, d)).astype(np.float32)
    rows = rng.integers(0, N, (T, B))
    edges = rng.integers(0, N, (T, 2, B))
    jcls = JH.MLPClassifier.init(jax.random.key(3), d, 8, CLASSES, layers,
                                 activate_type=act)
    tcls = TH.MLPClassifier(d, 8, CLASSES, layers, activate_type=act)
    tcls.load_state_dict(_state(jcls))
    np.testing.assert_allclose(
        tcls(torch.from_numpy(x), torch.from_numpy(rows)).detach().numpy(),
        np.asarray(jcls(jnp.asarray(x), jnp.asarray(rows))),
        rtol=1e-6, atol=1e-6)
    jedge = JH.EdgeClassifier.init(jax.random.key(4), d, 8, CLASSES, layers,
                                   activate_type=act)
    tedge = TH.EdgeClassifier(d, 8, CLASSES, layers, activate_type=act)
    tedge.load_state_dict(_state(jedge))
    for t in range(T):
        np.testing.assert_allclose(
            tedge(torch.from_numpy(x[t]),
                  torch.from_numpy(edges[t])).detach().numpy(),
            np.asarray(jedge(jnp.asarray(x[t]), jnp.asarray(edges[t]))),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TH.inner_product(torch.from_numpy(x), torch.from_numpy(edges)),
        np.asarray(JH.inner_product(jnp.asarray(x), jnp.asarray(edges))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------- a tiny labelled dataset

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """SNAPS snapshots of a weighted graph on N nodes with node labels (all
    nodes, shuffled) and edge labels (a subset of the edges), and its
    k-core pyramids, written by the port's preprocessing."""
    from ctgcn_torch.preprocessing import preprocess

    base = tmp_path_factory.mktemp("sup")
    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(N)]
    for d in ("nodes_set", "1.format", "nodes_label", "edges_label"):
        (base / d).mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    for t in range(SNAPS):
        src = rng.integers(0, N, 240)
        dst = (src + rng.integers(1, 12, 240)) % N
        w = rng.integers(1, 4, 240)
        (base / "1.format" / f"200{t}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"v{a}\tv{b}\t{c}\n" for a, b, c in zip(src, dst, w)))
        order = rng.permutation(N)
        (base / "nodes_label" / f"{t}.csv").write_text(
            "node\tlabel\n" + "".join(
                f"v{i}\t{rng.integers(0, CLASSES)}\n" for i in order))
        (base / "edges_label" / f"{t}.csv").write_text(
            "from_id\tto_id\tlabel\n" + "".join(
                f"v{a}\tv{b}\t{rng.integers(0, CLASSES)}\n"
                for a, b in zip(src[:150], dst[:150])))
    preprocess("CTGCN-C", {"base_path": str(base), "origin_folder": "1.format",
                           "core_folder": "cores",
                           "node_file": "nodes_set/nodes.csv",
                           "run_walk": False})
    return base, names


def test_label_and_edge_loaders_equal_jax(dataset):
    base, names = dataset
    t, j = TDataLoader(names, SNAPS), JDataLoader(names, SNAPS)
    for get, folder in (("get_node_label_list", "nodes_label"),
                        ("get_edge_label_list", "edges_label")):
        got, n_t = getattr(t, get)(str(base / folder), 1, 3)
        ref, n_j = getattr(j, get)(str(base / folder), 1, 3)
        assert n_t == n_j == CLASSES and len(got) == len(ref) == 3
        for a, b in zip(got, ref, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(t.get_edge_list(str(base / "1.format"), 0, SNAPS),
                    j.get_edge_list(str(base / "1.format"), 0, SNAPS),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def _same_splits(got, ref):
    assert set(got) == set(ref) == {"train", "val", "test"}
    for name in got:
        for a, b in zip(got[name], ref[name], strict=True):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("is_edge", [False, True], ids=["node", "edge"])
def test_label_splits_equal_jax(dataset, is_edge):
    base, names = dataset
    loader = TDataLoader(names, SNAPS)
    labels, _ = (loader.get_edge_label_list(str(base / "edges_label"), 0,
                                            SNAPS) if is_edge else
                 loader.get_node_label_list(str(base / "nodes_label"), 0,
                                            SNAPS))
    got = TS.build_label_splits(labels, 0.5, 0.3, 0.2, is_edge=is_edge)
    _same_splits(got, jdriver.build_label_splits(labels, 0.5, 0.3, 0.2,
                                                 is_edge=is_edge))
    assert got["train"][0].dtype == torch.int64
    assert got["train"][2].sum(1).tolist() == [
        int(np.floor(len(a) * 0.5)) for a in labels]


@pytest.mark.parametrize("lt", ["S-link-st", "S-link-dy"])
@pytest.mark.parametrize("seed", [0, 3])
def test_link_splits_equal_jax(dataset, lt, seed):
    base, names = dataset
    edges = TDataLoader(names, SNAPS).get_edge_list(str(base / "1.format"),
                                                    0, SNAPS)
    got = TS.build_link_splits(edges, N, 0.5, 0.3, 0.2, lt,
                               np.random.RandomState(seed))
    np.random.seed(seed)
    _same_splits(got, jdriver.build_link_splits(edges, N, 0.5, 0.3, 0.2, lt))
    items, labels, mask = got["train"]
    assert items.shape[0] == SNAPS - (lt == "S-link-dy")
    # half the slots of each timestamp are sampled non-edges
    assert (labels.sum(1) * 2 == mask.sum(1)).all()


# ------------------------------------------------------------------ AUC

def test_auc_helpers_equal_jax():
    rng = np.random.default_rng(4)
    T, B, C = 3, 50, 4
    mask = rng.random((T, B)) < 0.8
    logits = rng.standard_normal((T, B)).astype(np.float32) * 2
    y = rng.integers(0, 2, (T, B)).astype(np.float32)
    got = TS.binary_auc(torch.from_numpy(logits), torch.from_numpy(y),
                        torch.from_numpy(mask))
    assert abs(got - jdriver._binary_auc(jnp.asarray(logits), y, mask)) \
        <= 1e-12
    scores = rng.standard_normal((T, B, C)).astype(np.float32)
    ym = rng.integers(0, C, (T, B))
    got = TS.multiclass_auc(torch.from_numpy(scores), torch.from_numpy(ym),
                            torch.from_numpy(mask), C)
    ref = jdriver._multiclass_auc(scores, ym, mask, C)
    assert abs(got - ref) <= 1e-12 and 0.3 < got < 0.7
    # undefined: one class only, or two classes (the JAX package's sklearn
    # call rejects one binarized column against two score columns)
    ones = np.ones((T, B), np.float32)
    assert np.isnan(TS.binary_auc(torch.from_numpy(logits),
                                  torch.from_numpy(ones),
                                  torch.from_numpy(mask)))
    assert np.isnan(jdriver._binary_auc(jnp.asarray(logits), ones, mask))
    two = rng.integers(0, 2, (T, B))
    assert np.isnan(TS.multiclass_auc(torch.from_numpy(scores[..., :2]),
                                      torch.from_numpy(two),
                                      torch.from_numpy(mask), 2))
    assert np.isnan(jdriver._multiclass_auc(scores[..., :2], two, mask, 2))


# ------------------------------------------------- one supervised window

def _config(base, method, lt, backend):
    import json
    from pathlib import Path

    with open(Path(__file__).resolve().parent.parent / "configs"
              / "america-air.json") as fp:
        cfg = dict(json.load(fp)["embedding"][method])
    cfg.update(base_path=str(base), core_folder="cores", learning_type=lt,
               core_backend=backend, duration=SNAPS, hid_dim=12, embed_dim=6,
               cls_hid_dim=8, epoch=2, seed=5, record_time=False,
               elabel_folder="edges_label")
    return cfg


class _Captured(Exception):
    pass


def _jax_window(monkeypatch, cfg, method):
    """The JAX driver's trainer inputs for the config's first window."""
    seen = {}

    class Capture:
        def __init__(self, **kw):
            seen.update(kw)

        def learn_embedding(self, *splits, **kw):
            seen["splits"] = splits
            raise _Captured

    monkeypatch.setattr(jdriver, "SupervisedEmbedding", Capture)
    for var in ("CTGCN_TPU_REMAT_POLICY", "CTGCN_TPU_LAYER_REMAT"):
        monkeypatch.delenv(var, raising=False)
    np.random.seed(cfg["seed"])
    with pytest.raises(_Captured):
        jdriver.gnn_embedding(method, dict(cfg))
    return seen


def _port_window(monkeypatch, cfg, method):
    seen = {}

    class Capture(SupervisedEmbedding):
        def learn_embedding(self, **kw):
            seen["trainer"] = self
            raise _Captured

    monkeypatch.setattr(tdriver, "SupervisedEmbedding", Capture)
    with pytest.raises(_Captured):
        tdriver.gnn_embedding(method, dict(cfg), device="cpu")
    return seen["trainer"]


CASES = [("CTGCN-C", lt) for lt in ("S-node", "S-edge", "S-link-st",
                                    "S-link-dy")] + [("CTGCN-S", "S-link-st")]


@pytest.mark.parametrize("backend", ["blocks", "ell"])
@pytest.mark.parametrize("method, lt", CASES)
def test_supervised_window_equals_jax(dataset, monkeypatch, method, lt,
                                      backend):
    base, _ = dataset
    cfg = _config(base, method, lt, backend)
    jw = _jax_window(monkeypatch, cfg, method)
    trainer = _port_window(monkeypatch, cfg, method)
    assert trainer.data["adjs"].backend == backend
    T = SNAPS - (lt == "S-link-dy")
    assert trainer.data["adjs"].valid.shape[0] == T
    # the same features and splits
    if method == "CTGCN-S":
        np.testing.assert_array_equal(trainer.data["xs"].numpy(),
                                      np.asarray(jw["data"]["xs"]))
    ref_splits = dict(zip(("train", "val", "test"),
                          (jw["splits"][i:i + 3] for i in (0, 3, 6))))
    _same_splits(trainer.splits, ref_splits)

    # the JAX objective on the train split, and its gradients
    jmodels = (jw["model"], jw["classifier"])
    idx, labels, mask = jw["splits"][:3]

    def objective(models):
        preds, _, aux = jw["forward_fn"](models, jw["data"], idx, None)
        loss, acc = jw["loss_fn"](preds, labels, mask, aux)
        return loss, (acc, preds)

    (jloss, (jacc, jpreds)), jgrads = jax.jit(
        jax.value_and_grad(objective, has_aux=True))(jmodels)

    trainer.model.load_state_dict(_state(jw["model"]))
    modules = {"model": trainer.model}
    if jw["classifier"] is not None:
        trainer.classifier.load_state_dict(_state(jw["classifier"]))
        modules["classifier"] = trainer.classifier
    else:
        assert trainer.classifier is None
    loss, acc, preds = trainer._run("train")
    loss.backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(jpreds),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(acc.item(), float(jacc), rtol=1e-5)
    for key, mod, jg in zip(("model", "classifier"), modules.values(),
                            jgrads):
        ref = _state(jg)
        assert set(ref) == {k for k, _ in mod.named_parameters()}
        for name, p in mod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{key}.{name}")


# ------------------------------------------ best-on-validation is a copy

def test_best_on_val_parameters_are_copies(tmp_path):
    """Three epochs whose validation accuracy peaks at epoch 2: the saved
    model and classifier, the test forward and the exported embeddings are
    epoch 2's parameters, not the last ones."""
    (tmp_path / "origin").mkdir()
    (tmp_path / "origin" / "2001.csv").write_text("")
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(4, 4)
    cls = TH.MLPClassifier(4, 4, 3, 1, generator=gen)
    x = torch.randn(1, 5, 4, generator=gen)
    seen, val_acc = [], iter([0.75, 0.5])

    def forward_fn(model, classifier, data, items, generator=None):
        seen.append((torch.is_grad_enabled(),
                     model.weight.detach().clone(),
                     classifier.mlp.layers[0].weight.detach().clone()))
        return classifier(model(data["x"]), items), None

    def loss_fn(preds, labels, mask, aux):
        loss, acc = TL.classification_loss(preds, labels, mask)
        if not torch.is_grad_enabled() and len(seen) <= 5:
            acc = torch.tensor(next(val_acc))
        return loss, acc

    split = (torch.tensor([[0, 1, 2]]), torch.tensor([[0, 1, 2]]),
             torch.ones(1, 3, dtype=torch.bool))
    trainer = SupervisedEmbedding(
        base_path=str(tmp_path), origin_folder="origin",
        embedding_folder="emb", node_list=list(range(5)), model=model,
        classifier=cls, forward_fn=forward_fn, loss_fn=loss_fn,
        embed_fn=lambda m, d: m(d["x"]), auc_fn=lambda p, y, m: 0.5,
        data={"x": x}, splits=dict.fromkeys(("train", "val", "test"), split),
        device="cpu")
    res = trainer.learn_embedding(epoch=3, lr=0.1, model_file="m",
                                  classifier_file="c", verbose=False)
    # forwards: train 1, train 2, val 2, train 3, val 3, test
    assert [g for g, _, _ in seen] == [True, True, False, True, False, False]
    epoch2 = seen[2]                      # the parameters after two steps
    last = (model.weight, cls.mlp.layers[0].weight)
    assert res["acc_val"] == [0.75, 0.5] and res["best_acc_val"] == 0.75
    assert not torch.equal(epoch2[1], seen[4][1])
    saved_m = read_model_file(tmp_path / "model" / "m")
    saved_c = read_model_file(tmp_path / "model" / "c")
    assert torch.equal(saved_m["weight"], epoch2[1])
    assert torch.equal(saved_c["mlp.layers.0.weight"], epoch2[2])
    assert torch.equal(seen[5][1], epoch2[1])       # the test forward
    assert torch.equal(last[0], epoch2[1]) and torch.equal(last[1], epoch2[2])
    _, emb = read_embedding_csv(tmp_path / "emb" / "2001.csv")
    np.testing.assert_array_equal(
        emb, (x[0] @ epoch2[1].T + model.bias).detach().numpy())
