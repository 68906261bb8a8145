# coding: utf-8
"""PGNN (``ctgcn_torch/nn/pgnn.py`` and its driver path) against
``ctgcn_tpu`` on the CPU, from numpy seeds, the JAX parameters carried
over by ``params_from_numpy``.

  * ``precompute_dist_data`` on a graph of N = 70 nodes with isolated ones,
    T = 2, ``approximate`` -1 and 2, in one row chunk and in many:
    bit-equal to the JAX function; an asymmetric matrix raises.
  * ``anchor_sizes``: equal for N from 1 to 87,036.
  * The anchor reduction given the JAX package's own anchor sets
    (reproduced from its keys), on matrices with all-zero rows and ties (at
    ``approximate: 2`` proximities take four values), in one gather chunk
    and in many: ``dists_argmax`` equal, ``dists_max`` within 1e-7;
    ``draw_anchor_sets`` draws distinct ids in the sizes asked for, and
    uniformly.
  * ``PGNN`` with ``layer_num`` 1, 2 and 3, ``feature_pre`` on (identity
    features) and off (given features), no dropout: forward and parameter
    gradients within 1e-5 of the largest JAX value (the output's, the
    gradients' over the model); ``params_from_numpy``
    maps the tree (bias or not).
  * The driver: the window's proximity matrices and the model against the
    JAX driver's, and its forward given the JAX forward's anchors (drawn
    from ``key(0)``); the eval-time dropout trap (without a generator the
    forward draws from a generator seeded 0: the same at every call, and
    not the forward without dropout); the width rule (the S-node
    classifier takes one input per anchor set, as in the JAX driver).
  * The CLI runs ``configs/uci.json``'s (S-link-st) and
    ``configs/america-air.json``'s (S-node) PGNN entries at test width.
  * U-neg, which the JAX driver allows though no config asks for it, on
    ``tests/test_torch_zoo.py``'s dataset (its walk tables): the loss of a
    batch against the JAX driver's (its anchors from the forward's key,
    its sampler's draws), and the CLI.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from flax import serialization

from ctgcn_torch import main as cli
from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn import pgnn as TP
from ctgcn_torch.training import driver as TD
from ctgcn_tpu.nn import pgnn as JP
from ctgcn_tpu.training import driver as JD
from tests.test_torch_ctgcn import Q, S
from tests.test_torch_zoo import _draws, _walk_paths
from tests.test_torch_zoo import dataset as zoo_dataset  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N, T, FEAT, HID, EMB = 70, 2, 10, 12, 6
#: the model tests' last width: at 6 a node's last-layer units can all be
#: dead (``test_zero_position_row_diverges_from_jax``)
OUT = 16
LN, LT, LCLASSES = 64, 3, 3
TOL = 1e-5


def _edge_list(seed=0, n=N, t=T, edges=90, isolated=4):
    """t snapshots of a random graph on n nodes, the last ``isolated`` of
    them without edges: one int64 [2, E] array each, both directions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(t):
        src = rng.integers(0, n - isolated, edges)
        dst = rng.integers(0, n - isolated, edges)
        a = sp.coo_matrix((np.ones(edges), (src, dst)), shape=(n, n))
        a = ((a + a.T) != 0).tocoo()
        out.append(np.stack([a.row, a.col]).astype(np.int64))
    return out


def _tree(jmodel):
    return jax.tree.map(np.asarray, serialization.to_state_dict(jmodel))


def _load(tmodel, jmodel):
    state = params_from_numpy(_tree(jmodel))
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return tmodel


def _jax_anchor_sets(key, n):
    """The anchor sets ``select_anchor_dists`` draws from ``key``."""
    sizes = JP.anchor_sizes(n)
    return [torch.from_numpy(np.array(
        jax.lax.top_k(jax.random.uniform(k, (n,)), max(s, 1))[1])).long()
        for s, k in zip(sizes, jax.random.split(key, len(sizes)))]


def _jax_window_anchor_sets(n, t):
    """The anchor sets of each snapshot that the JAX driver's PGNN forward
    draws without a key (``key(0)``)."""
    ka, _ = jax.random.split(jax.random.key(0))
    return [_jax_anchor_sets(k, n) for k in jax.random.split(ka, t)]


# ------------------------------------------------- proximity matrices

@pytest.mark.parametrize("chunked", [False, True], ids=["one", "chunks"])
@pytest.mark.parametrize("approximate", [-1, 2])
def test_precompute_dist_data_bit_equal_jax(monkeypatch, approximate,
                                            chunked):
    edges = _edge_list()
    if chunked:     # 7 rows a dijkstra chunk, 16-row symmetry tiles
        monkeypatch.setattr(TP, "DIST_CHUNK_ELEMS", 7 * N)
        monkeypatch.setattr(TP._check_symmetric, "__defaults__", (16,))
    got = TP.precompute_dist_data(edges, N, approximate=approximate)
    ref = JP.precompute_dist_data(edges, N, approximate=approximate)
    assert got.dtype == torch.float32 and got.shape == (T, N, N)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not ref[:, -1, :-1].any()             # an isolated node
    if approximate == 2:
        assert set(np.unique(ref)) == {0.0, np.float32(1 / 3), 0.5, 1.0}


@pytest.mark.parametrize("tile", [2, 512])
def test_asymmetric_proximity_raises(tile):
    prox = np.eye(5, dtype=np.float32)
    prox[1, 3] = 0.5
    TP._check_symmetric(np.eye(5, dtype=np.float32), tile)
    with pytest.raises(AssertionError, match="symmetric"):
        TP._check_symmetric(prox, tile)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 60, 1190, 1899, 6828, 24740,
                               87036])
def test_anchor_sizes_equal_jax(n):
    assert TP.anchor_sizes(n) == JP.anchor_sizes(n)


# ------------------------------------------------- the anchor reduction

@pytest.mark.parametrize("chunk_elems", [TP.REDUCE_CHUNK_ELEMS, 3 * N],
                         ids=["one", "chunks"])
@pytest.mark.parametrize("approximate", [-1, 2])
def test_anchor_reduction_equals_jax(approximate, chunk_elems):
    """Given the JAX anchors: the same argmax (the first anchor among
    equals, ``anchor_idx[0]`` on a row that reaches none), the same max."""
    dists = JP.precompute_dist_data(_edge_list(1), N, approximate)[0]
    key = jax.random.key(3)
    jm, ja = JP.select_anchor_dists(key, jnp.asarray(dists),
                                    JP.anchor_sizes(N))
    sets = _jax_anchor_sets(key, N)
    tm, ta = TP.anchor_reduce(torch.from_numpy(dists), sets,
                              chunk_elems=chunk_elems)
    assert ta.dtype == torch.int64 and ta.shape == (N, len(sets))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-7)
    # ties and empty rows are the rule: an isolated node reaches only
    # itself, so every set without it gives 0 at the set's first anchor
    away = [k for k, s in enumerate(sets) if N - 1 not in s.tolist()]
    assert away and not tm[-1, away].any()
    np.testing.assert_array_equal(ta[-1, away].numpy(),
                                  [int(sets[k][0]) for k in away])


def test_draw_anchor_sets_uniform_without_replacement():
    sizes = TP.anchor_sizes(N)
    gen = torch.Generator().manual_seed(0)
    sets = TP.draw_anchor_sets(N, sizes, gen)
    assert [len(s) for s in sets] == [max(s, 1) for s in sizes]
    assert all(len(set(s.tolist())) == len(s) for s in sets)
    # 4000 draws of 5 of 20 nodes: each node 1000 times, sd about 27
    counts = np.zeros(20)
    for _ in range(4000):
        counts[TP.draw_anchor_sets(20, [5], gen)[0].numpy()] += 1
    assert np.abs(counts - 1000).max() < 6 * 27.4


# ------------------------------------------------------------ the model

def _model_inputs(features):
    dists = JP.precompute_dist_data(_edge_list(2), N, 2)
    dm, da = zip(*(JP.select_anchor_dists(k, jnp.asarray(d),
                                          JP.anchor_sizes(N))
                   for k, d in zip(jax.random.split(jax.random.key(4), T),
                                   dists)))
    dm, da = jnp.stack(dm), jnp.stack(da)
    xs = (np.random.default_rng(5).standard_normal((T, N, FEAT))
          .astype(np.float32) if features else None)
    return xs, dm, da


def _models(feature_pre, layer_num, out_dim):
    in_dim = N if feature_pre else FEAT
    jmodel = JP.PGNN.init(jax.random.key(6), in_dim, 8, HID, out_dim,
                          feature_pre=feature_pre, layer_num=layer_num,
                          dropout=0.5)
    return jmodel, _load(TP.PGNN(in_dim, 8, HID, out_dim,
                                 feature_pre=feature_pre,
                                 layer_num=layer_num, dropout=0.5), jmodel)


@pytest.mark.parametrize("layer_num", [1, 2, 3])
@pytest.mark.parametrize("feature_pre", [True, False],
                         ids=["pre-identity", "features"])
def test_pgnn_forward_and_grads_equal_jax(layer_num, feature_pre):
    xs, dm, da = _model_inputs(features=not feature_pre)
    jmodel, tmodel = _models(feature_pre, layer_num, OUT)
    A = dm.shape[-1]
    w = np.random.default_rng(7).standard_normal((T, N, A)).astype(
        np.float32)
    jx = None if xs is None else jnp.asarray(xs)

    def jloss(m):
        out = m(jx, (dm, da))
        return jnp.sum(jnp.tanh(out) * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jmodel)
    out = tmodel(None if xs is None else torch.from_numpy(xs),
                 torch.from_numpy(np.array(dm)),
                 torch.from_numpy(np.array(da)).long())
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    assert out.shape == (T, N, A)
    jout = np.asarray(jout)
    assert np.abs(jout).sum(-1).all()           # no all-zero row
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=TOL * np.abs(jout).max())
    ref = params_from_numpy(_tree(jgrads))
    scale = max(float(v.abs().max()) for v in ref.values())
    for name, p in tmodel.named_parameters():
        # the first layer's position head feeds nothing when layer_num > 1
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=0,
                                   atol=TOL * scale, err_msg=name)


def test_zero_position_row_diverges_from_jax():
    """A reference hazard the port does not copy: where a node's last
    position row is all zeros (every unit of its last layer dead, biases
    still zero), the JAX norm's gradient is NaN, and so is the last
    position head's; torch's norm has the subgradient 0 there, so the
    port's gradients stay finite.  The forwards agree."""
    xs, dm, da = _model_inputs(features=True)
    jmodel, tmodel = _models(False, 2, EMB)
    jfn = lambda m: jnp.sum(m(jnp.asarray(xs), (dm, da)))    # noqa: E731
    jout = np.asarray(jmodel(jnp.asarray(xs), (dm, da)))
    out = tmodel(torch.from_numpy(xs), torch.from_numpy(np.array(dm)),
                 torch.from_numpy(np.array(da)).long())
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=TOL * np.abs(jout).max())
    assert not np.abs(jout).sum(-1).all()       # an all-zero row
    jgrads = params_from_numpy(_tree(jax.grad(jfn)(jmodel)))
    # the NaN reaches the last position head; a dead ReLU stops it there
    assert jgrads["conv_out.linear_out_position.weight"].isnan().any()
    out.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in tmodel.parameters()
               if p.grad is not None)


@pytest.mark.parametrize("layer_num, feature_pre, bias", [
    (1, True, True), (2, False, True), (3, True, False)])
def test_params_from_numpy_maps_the_pgnn_tree(layer_num, feature_pre, bias):
    """``linear_pre``, ``conv_first``, ``conv_hidden.<i>`` and ``conv_out``,
    each with ``dist_compute.linear{1,2}``, ``linear_hidden`` and
    ``linear_out_position``; ``None`` leaves dropped."""
    jmodel = JP.PGNN.init(jax.random.key(8), N, 8, HID, EMB,
                          feature_pre=feature_pre, layer_num=layer_num,
                          bias=bias)
    tmodel = _load(TP.PGNN(N, 8, HID, EMB, feature_pre=feature_pre,
                           layer_num=layer_num, bias=bias), jmodel)
    names = set(tmodel.state_dict())
    assert ("linear_pre.weight" in names) is feature_pre
    assert ("conv_out.linear_hidden.weight" in names) is (layer_num > 1)
    assert ("conv_hidden.0.dist_compute.linear1.weight" in names) is (
        layer_num == 3)
    assert any(n.endswith("bias") for n in names) is bias


def test_init_follows_the_jax_rule():
    """xavier-uniform at ReLU's gain, zero biases: every weight inside its
    bound and spread over it."""
    model = TP.PGNN(300, 32, 200, 128, generator=torch.Generator()
                    .manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            bound = np.sqrt(2.0) * np.sqrt(6.0 / sum(p.shape))
            top = float(p.detach().abs().max())
            assert top <= bound, name
            if p.numel() >= 1000:
                assert top > 0.95 * bound, name


# ------------------------------------------------------------ the driver

@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """LT snapshots of a weighted graph on LN named nodes, the last four
    isolated, with node labels (every node) and edge labels (a subset of
    the edges)."""
    base = tmp_path_factory.mktemp("pgnn")
    rng = np.random.default_rng(0)
    names = [f"w{i}" for i in range(LN)]
    for d in ("nodes_set", "1.format", "nodes_label", "edges_label"):
        (base / d).mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    for t in range(LT):
        src = rng.integers(0, LN - 4, 200)
        dst = (src + rng.integers(1, 9, 200)) % (LN - 4)
        w = rng.integers(1, 4, 200)
        (base / "1.format" / f"201{t}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"w{a}\tw{b}\t{c}\n" for a, b, c in zip(src, dst, w)))
        (base / "nodes_label" / f"{t}.csv").write_text(
            "node\tlabel\n" + "".join(
                f"w{i}\t{rng.integers(0, LCLASSES)}\n"
                for i in rng.permutation(LN)))
        (base / "edges_label" / f"{t}.csv").write_text(
            "from_id\tto_id\tlabel\n" + "".join(
                f"w{a}\tw{b}\t{rng.integers(0, LCLASSES)}\n"
                for a, b in zip(src[:120], dst[:120])))
    return base, names


def _config(base, data, method, **change):
    """``configs/<data>.json``'s ``method`` entry on ``base`` at test width
    (hid 12, feature 8, embed 6, classifier hidden 8, 2 epochs)."""
    with open(ROOT / "configs" / f"{data}.json") as fp:
        cfg = dict(json.load(fp)["embedding"][method])
    cfg.update(base_path=str(base), hid_dim=HID, embed_dim=EMB,
               cls_hid_dim=8, epoch=2, record_time=False, seed=0,
               elabel_folder="edges_label")
    if "feature_dim" in cfg:
        cfg["feature_dim"] = 8
    cfg.update(change)
    return cfg


@pytest.mark.parametrize("approximate", [-1, 2])
def test_driver_window_and_forward_equal_jax(labelled, approximate):
    """The window's proximity matrices bit-equal to the JAX driver's, no
    adjacency, the model from what the JAX factory passes, and the
    driver's forward (no generator, the JAX anchors given, dropout 0)
    against the JAX forward without a key."""
    base, _ = labelled
    cfg = _config(base, "uci", "PGNN", approximate=approximate, dropout=0.0)
    jargs, targs = dict(cfg), dict(cfg)
    jl, tl = JD.get_data_loader(jargs), TD.get_data_loader(targs)
    in_j, _, jxs, _ = JD.get_input_data("PGNN", 0, 2, jl, jargs)
    in_t, data = TD.get_input_data("PGNN", 0, 2, tl, targs)
    assert in_t == in_j == LN and jxs is None and data["xs"] is None
    assert "adjs" not in data and TD._adj_backend(data) == "dense"
    np.testing.assert_array_equal(data["pgnn_dists"].numpy(),
                                  np.asarray(jargs["_pgnn_dists"]))
    jargs["input_dim"] = targs["input_dim"] = LN
    jmodel = JD.get_gnn_model("PGNN", 2, jargs, jax.random.key(5))
    tmodel = _load(TD.get_gnn_model("PGNN", 2, targs,
                                    torch.Generator().manual_seed(0)),
                   jmodel)
    assert tmodel.layer_num == 2 and tmodel.linear_pre.weight.shape == (
        LN, 8)
    jout = np.asarray(JD.make_forward("PGNN")(
        jmodel, {"xs": None, "pgnn_dists": jargs["_pgnn_dists"]}, None))
    out = TD._pgnn_forward(tmodel, data,
                           anchor_sets=_jax_window_anchor_sets(LN, 2))
    assert out.shape == (2, LN, len(TP.anchor_sizes(LN)))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=TOL * np.abs(jout).max())


def test_forward_drops_out_without_a_generator(labelled):
    """The eval-time dropout trap: without a generator the driver's forward
    draws the anchors and dropout from a generator seeded 0 made at every
    call, so two calls agree, and differ from the forward without
    dropout (the same anchors: they are drawn first)."""
    base, _ = labelled
    args = _config(base, "uci", "PGNN")
    assert args["dropout"] == 0.5
    trainer = TD.build_trainer("PGNN", args, TD.get_data_loader(args), 0, 2,
                               torch.device("cpu"),
                               torch.Generator().manual_seed(0))
    m, d = trainer.model, trainer.data
    with torch.no_grad():
        first = trainer.embed_fn(m, d)
        torch.testing.assert_close(trainer.embed_fn(m, d), first, rtol=0,
                                   atol=0)
        items = trainer.splits["val"][0]
        torch.testing.assert_close(trainer.forward_fn(m, None, d, items)[0],
                                   trainer.forward_fn(m, None, d, items)[0],
                                   rtol=0, atol=0)
        m.dropout = 0.0
        plain = trainer.embed_fn(m, d)
    assert first.shape == plain.shape == (2, LN, len(TP.anchor_sizes(LN)))
    assert not torch.allclose(first, plain)


def test_width_rule(labelled, monkeypatch):
    """Under S-node the classifier takes len(anchor_sizes(N)) inputs, not
    ``embed_dim``, in both drivers."""
    from tests.test_torch_supervised import _jax_window, _port_window

    base, _ = labelled
    cfg = _config(base, "america-air", "PGNN", end_idx=0)
    width = len(TP.anchor_sizes(LN))
    assert width != cfg["embed_dim"]
    jw = _jax_window(monkeypatch, cfg, "PGNN")
    trainer = _port_window(monkeypatch, cfg, "PGNN")
    jw0 = np.asarray(jw["classifier"].mlp.layers[0].weight)
    assert trainer.classifier.mlp.layers[0].weight.shape == jw0.shape == (
        width, cfg["cls_hid_dim"] if cfg["cls_layer_num"] > 1
        else LCLASSES)


@pytest.mark.parametrize("data, lt", [("uci", "S-link-st"),
                                      ("america-air", "S-node")])
def test_cli_runs_each_configs_pgnn(labelled, tmp_path, data, lt):
    """The config's PGNN entry as written but for the test widths, through
    ``ctgcn_torch.main`` on the CPU: finite losses, test accuracy and AUC
    in [0, 1], "dense" in every window, one CSV per snapshot of width A."""
    from ctgcn_torch.data.formats import read_embedding_csv

    base, names = labelled
    cfg = _config(base, data, "PGNN", embed_folder=f"2.embedding/{data}",
                  model_file=f"pgnn-{data}")
    assert cfg["learning_type"] == lt
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {"PGNN": cfg}}))
    results = cli.main([f"--config={path}", "--task=embedding",
                        "--method=PGNN", "--device=cpu"])
    assert [r["core_backend"] for r in results] == ["dense"] * len(results)
    assert sum(r["time_length"] for r in results) == LT
    for r in results:
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert 0.0 <= r["acc_test"] <= 1.0
    files = sorted((base / cfg["embed_folder"]).iterdir())
    assert [f.name for f in files] == [f"201{t}.csv" for t in range(LT)]
    for f in files:
        got_names, arr = read_embedding_csv(f)
        assert got_names == names and arr.shape == (
            LN, len(TP.anchor_sizes(LN)))
        assert np.isfinite(arr).all()
    model_dir = base / cfg["model_folder"]
    assert (model_dir / cfg["model_file"]).is_file()
    assert (model_dir / "pgnn_cls").is_file() is (lt == "S-node")


def _uneg_config(zoo):
    base, _, emb = zoo
    return dict(emb["GCN"], **{k: v for k, v in _config(
        base, "uci", "PGNN").items() if k not in emb["GCN"]},
        model_file="pgnn-uneg", embed_folder="2.embedding/pgnn-uneg",
        learning_type="U-neg", Q=Q, neg_num=S, hid_dim=HID, embed_dim=EMB)


def test_uneg_loss_equals_jax(zoo_dataset):
    """The driver's U-neg loss of one batch (dropout 0): the forward's
    anchors from the first half of the key, the sampler's draws from the
    second, as the JAX ``_uneg_loss_fn`` splits it."""
    from ctgcn_torch import losses as TL
    from tests.test_torch_zoo import N as ZN, T as ZT

    cfg = dict(_uneg_config(zoo_dataset), dropout=0.0)
    jargs, targs = dict(cfg), dict(cfg)
    jl, tl = JD.get_data_loader(jargs), TD.get_data_loader(targs)
    JD.get_input_data("PGNN", 0, ZT, jl, jargs)
    _, data = TD.get_input_data("PGNN", 0, ZT, tl, targs)
    jargs["input_dim"] = targs["input_dim"] = ZN
    jmodel = JD.get_gnn_model("PGNN", ZT, jargs, jax.random.key(5))
    tmodel = _load(TD.get_gnn_model("PGNN", ZT, targs,
                                    torch.Generator().manual_seed(0)),
                   jmodel)
    walk_j = jl.get_walk_data(*_walk_paths(targs), 0, ZT)
    data["walk"] = tl.get_walk_data(*_walk_paths(targs), 0, ZT)
    jdata = {"xs": None, "pgnn_dists": jargs["_pgnn_dists"], "walk": walk_j}
    b_idx = np.random.default_rng(6).permutation(ZN)[:48].astype(np.int32)
    b_mask = np.ones(48, bool)
    key = jax.random.key(7)
    jloss_fn = JD._uneg_loss_fn(JD.make_forward("PGNN"), False, S, Q)
    jval, jgrads = jax.value_and_grad(
        lambda m: jloss_fn(m, jdata, jnp.asarray(b_idx),
                           jnp.asarray(b_mask), key))(jmodel)
    k_drop, k_samp = jax.random.split(key)
    ka, _ = jax.random.split(k_drop)
    anchors = [_jax_anchor_sets(k, ZN) for k in jax.random.split(ka, ZT)]
    j, neg = _draws(k_samp, walk_j, b_idx)
    loss = TL.uneg_loss(TD._pgnn_forward(tmodel, data, anchor_sets=anchors),
                        torch.from_numpy(b_idx).long(),
                        torch.from_numpy(b_mask), data["walk"], j, neg, Q=Q)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=TOL)
    ref = params_from_numpy(_tree(jgrads))
    scale = max(float(v.abs().max()) for v in ref.values())
    for name, p in tmodel.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=0,
                                   atol=TOL * scale, err_msg=name)


def test_cli_runs_pgnn_under_uneg(zoo_dataset, tmp_path):
    base, names, _ = zoo_dataset
    cfg = _uneg_config(zoo_dataset)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {"PGNN": cfg}}))
    results = cli.main([f"--config={path}", "--task=embedding",
                        "--method=PGNN", "--device=cpu"])
    assert [r["core_backend"] for r in results] == ["dense"] * len(results)
    assert all(np.isfinite(r["losses"]).all() for r in results)
    files = sorted((base / cfg["embed_folder"]).iterdir())
    assert [f.name for f in files] == ["2010-01.csv", "2010-02.csv"]
