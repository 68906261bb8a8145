# coding: utf-8
"""The zoo's first slice (GCN, TgGCN, GIN, TgGIN) against ``ctgcn_tpu`` on
the CPU, on a generated dataset (N = 120 named nodes, two weighted
snapshots, node u119 isolated; walk tables from the port's preprocessing,
which both packages read).

  * GCN and GIN forward and parameter gradients with dropout off, the JAX
    parameters carried across by ``params_from_numpy``: GCN with identity
    and with file-like features, GIN pooling by sum, average and max, with
    and without ``learn_eps``, on the segment SpMM and on the kernels'
    plans (their plain versions here).  Forward within 1e-5 (rtol and
    atol); gradients within 1e-4 of the value plus 1e-4 of the model's
    largest gradient (``_check_grads``).
  * The driver's four methods end to end on a two-snapshot window: the
    adjacency each method gets (normalization, +I, plans) equal to the JAX
    driver's, the traps included, and the U-neg loss (the JAX sampler's
    draws) within 1e-5 and its gradients as above.
  * The CLI runs each method and exports its CSVs; unported methods and
    options raise.
  * The dataset fixture and the driver and CLI checks serve the zoo's
    later slices too (``tests/test_torch_gat.py``,
    ``tests/test_torch_sage.py``).
  * Dropout: keep rate 0.5 +- 0.01 over 10^5 draws, kept values doubled.
  * Training statistics: GCN with dropout 0.5 under U-neg, 5 epochs, from
    the same initial parameters in both packages, seeds 0-2: the mean
    relative gap of the final loss within ``LOSS_REL_GAP`` (the
    frameworks' dropout masks, negatives and batch orders differ).
"""
import contextlib
import io
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ctgcn_torch import losses as TL
from ctgcn_torch import main as cli
from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn.gcn import GCN as TGCN
from ctgcn_torch.nn.gcn import _dropout as t_dropout
from ctgcn_torch.nn.gin import GIN as TGIN
from ctgcn_torch.ops.ell import EvPlan
from ctgcn_torch.ops import neighbors as TN
from ctgcn_torch.ops import sparse as TS
from ctgcn_torch.training import driver as TD
from ctgcn_tpu.data.loader import DataLoader as JDataLoader
from ctgcn_tpu.nn.gcn import GCN as JGCN
from ctgcn_tpu.nn.gcn import _dropout as j_dropout
from ctgcn_tpu.nn.gin import GIN as JGIN
from ctgcn_tpu.ops import neighbors as JN
from ctgcn_tpu.ops import sparse as JS
from ctgcn_tpu.training import driver as JD
from ctgcn_tpu.training.engine import \
    UnsupervisedEmbedding as JUnsupervisedEmbedding
from tests.test_torch_ctgcn import Q, S, _jax_draws_t

ROOT = Path(__file__).resolve().parent.parent
N, T, HID, EMB, FEAT = 120, 2, 12, 6, 10
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
METHODS = ("GCN", "TgGCN", "GIN", "TgGIN")
#: every zoo method the port runs, as the dataset fixture configures them
ZOO = METHODS + ("GAT", "TgGAT", "SAGE", "TgSAGE", "GCRN", "EvolveGCN",
                 "VGRNN")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The generated dataset, preprocessed by the port's CLI (walk tables
    under ``CTGCN/ctgcn_walk_pairs``), and the zoo entries of
    configs/uci.json narrowed to test size, all reading those tables."""
    base = tmp_path_factory.mktemp("zoo")
    rng = np.random.default_rng(0)
    names = [f"u{i}" for i in range(N)]
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    (base / "1.format").mkdir()
    for t in range(T):
        src = rng.integers(0, N - 1, 360)
        dst = rng.integers(0, N - 1, 360)
        (base / "1.format" / f"2010-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"u{a}\tu{b}\t{rng.integers(1, 5)}\n"
                for a, b in zip(src, dst)))
    with open(ROOT / "configs" / "uci.json") as fp:
        uci = json.load(fp)
    pre = dict(uci["preprocessing"]["CTGCN-C"], base_path=str(base),
               walk_time=3)
    emb = {m: dict(uci["embedding"][m], base_path=str(base), hid_dim=HID,
                   embed_dim=EMB, batch_size=50, neg_num=S, epoch=1,
                   record_time=False,
                   walk_pair_folder="CTGCN/ctgcn_walk_pairs",
                   node_freq_folder="CTGCN/ctgcn_node_freq")
           for m in ZOO}
    cfg = base / "cfg.json"
    cfg.write_text(json.dumps({"preprocessing": {"CTGCN-C": pre},
                               "embedding": emb}))
    cli.main([f"--config={cfg}", "--task=preprocessing", "--method=CTGCN-C",
              "--device=cpu"])
    return base, names, emb


def _tree(jmodel):
    return jax.tree.map(np.asarray, serialization.to_state_dict(jmodel))


def _load(tmodel, jmodel):
    state = params_from_numpy(_tree(jmodel))
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return tmodel


def _check_grads(tmodel, jgrads):
    """Each gradient within GRAD_TOL of its value plus GRAD_TOL of the
    model's largest gradient (at least 1): GIN's BatchNorms scale its
    gradients into the hundreds, where the two packages' f32 sums differ by
    about 1e-4 absolute (a gradient of a bias before a BatchNorm is zero
    but for that noise)."""
    ref = params_from_numpy(_tree(jgrads))
    scale = max([1.0] + [float(v.abs().max()) for v in ref.values()])
    for name, p in tmodel.named_parameters():
        got = (p.grad if p.grad is not None else torch.zeros_like(p))
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=name)


def _windows(dataset, add_eye, normalize, adj_backend):
    """(port graphs, JAX window) of both snapshots."""
    base, names, _ = dataset
    kw = dict(normalize=normalize, row_norm=normalize, add_eye=add_eye,
              adj_backend=adj_backend)
    origin = str(base / "1.format")
    return (TDataLoader(names, T).get_date_adj_list(origin, 0, T, **kw),
            JDataLoader(names, T).get_date_adj_list(origin, 0, T, **kw))


def _neighbors(dataset):
    base, names, _ = dataset
    mats = TDataLoader(names, T).get_scipy_adj_list(
        str(base / "1.format"), 0, T)
    jn, jd = JN.neighbor_table_from_scipy(mats)
    tn, td = TN.neighbor_table_from_scipy(mats)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    return (jn, jd), (tn, td)


def _features(features):
    if not features:
        return N, None, None
    xs = np.random.default_rng(3).standard_normal((T, N, FEAT)).astype(
        np.float32)
    return FEAT, jnp.asarray(xs), torch.from_numpy(xs)


def _compare(jmodel, tmodel, jcall, tcall):
    """Forward and gradients of sum(tanh(out) * w) in both packages."""
    w = np.random.default_rng(4).standard_normal((T, N, EMB)).astype(
        np.float32)

    def jloss(m):
        out = jcall(m)
        return jnp.sum(jnp.tanh(out) * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jmodel)
    out = tcall(tmodel)
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    assert out.shape == (T, N, EMB)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(tmodel, jgrads)


@pytest.mark.parametrize("adj_backend", ["segment", "ell"])
@pytest.mark.parametrize("features", [False, True],
                         ids=["identity", "features"])
def test_gcn_forward_and_grads_equal_jax(dataset, features, adj_backend):
    tgraphs, jwin = _windows(dataset, True, True, adj_backend)
    in_dim, jxs, txs = _features(features)
    jmodel = JGCN.init(jax.random.key(1), in_dim, HID, EMB, dropout=0.5)
    tmodel = _load(TGCN(in_dim, HID, EMB, dropout=0.5), jmodel)
    _compare(jmodel, tmodel, lambda m: m(jxs, jwin),
             lambda m: m(txs, tgraphs))


@pytest.mark.parametrize("pooling, learn_eps, adj_backend", [
    ("sum", False, "segment"), ("sum", True, "segment"),
    ("average", False, "segment"), ("average", True, "segment"),
    ("max", False, "segment"), ("max", True, "segment"),
    ("sum", False, "ell"), ("average", True, "ell")])
def test_gin_forward_and_grads_equal_jax(dataset, pooling, learn_eps,
                                         adj_backend):
    """Dropout off; BatchNorm on the batch's statistics in both."""
    tgraphs, jwin = _windows(dataset, not learn_eps, False, adj_backend)
    (jn, jd), (tn, td) = _neighbors(dataset)
    jmodel = JGIN.init(jax.random.key(2), N, HID, EMB, layer_num=2,
                       mlp_layer_num=2, learn_eps=learn_eps,
                       pooling_type=pooling, dropout=0.5)
    # a learnt eps away from its zero init
    jmodel = jmodel.replace(eps=jnp.asarray([0.3, -0.2], jnp.float32))
    tmodel = _load(TGIN(N, HID, EMB, 2, 2, learn_eps=learn_eps,
                        pooling_type=pooling, dropout=0.5), jmodel)
    _compare(jmodel, tmodel, lambda m: m(None, jwin, (jn, jd)),
             lambda m: m(None, tgraphs, (tn, td)))


def test_gin_pools_isolated_nodes_to_zero(dataset):
    """Max pooling gives node u119 (no neighbour) a zero row before its
    MLP, so its embedding is the same as another isolated node's would
    be: every row of the pooled input is zero there."""
    (_, _), (tn, td) = _neighbors(dataset)
    assert int(td[0, N - 1]) == 0
    h = torch.randn(N, HID, generator=torch.Generator().manual_seed(0))
    pooled = TN.masked_max_pool(h, tn[0], td[0])
    assert not pooled[N - 1].any()


def _draws(key, walk_j, b_idx):
    """The positive slots [T, B, S] and negatives [T, S] the JAX U-neg loss
    draws from ``key``."""
    js, negs = zip(*(
        _jax_draws_t(t_key, walk_j.degrees[t][jnp.asarray(b_idx)],
                     walk_j.neg_logits[t])
        for t, t_key in enumerate(jax.random.split(key, T))))
    return (torch.from_numpy(np.stack(js)).long(),
            torch.from_numpy(np.stack(negs)).long())


def _walk_paths(args):
    return [str(Path(args["base_path"]) / args[k])
            for k in ("walk_pair_folder", "node_freq_folder")]


@pytest.mark.parametrize("method, change", [
    ("GCN", {}), ("GCN", {"adj_backend": "ell"}),
    ("TgGCN", {}), ("TgGCN", {"adj_backend": "ell"}),
    ("GIN", {}), ("GIN", {"adj_backend": "ell"}),
    ("GIN", {"pooling_type": "max"}),
    ("TgGIN", {}), ("TgGIN", {"adj_backend": "ell"})],
    ids=["GCN", "GCN-ell", "TgGCN", "TgGCN-ell", "GIN", "GIN-ell",
         "GIN-max", "TgGIN", "TgGIN-ell"])
def test_driver_window_and_loss_equal_jax(dataset, method, change):
    """Both drivers' inputs, models and U-neg loss for one window (dropout
    0, so the loss is deterministic); the adjacency of each method, with
    its parity traps: GCN D^-1 (A + I), TgGCN the raw A, GIN A + I
    (``learn_eps: false``), TgGIN the raw A with a learnt eps; GIN's
    ``pooling_type: "max"`` builds the neighbor table but the model pools
    by sum."""
    _driver_window_and_loss(dataset, method, change)


#: the adjacency each zoo method gets, from the raw dense A
ADJACENCY = {
    "GCN": lambda a: (a + np.eye(N)) / (a + np.eye(N)).sum(1, keepdims=True),
    "TgGCN": lambda a: a, "GIN": lambda a: a + np.eye(N),
    "TgGIN": lambda a: a}
ADJACENCY.update(GAT=ADJACENCY["GCN"], TgGAT=ADJACENCY["TgGCN"],
                 SAGE=ADJACENCY["TgGCN"], TgSAGE=ADJACENCY["TgGCN"],
                 GCRN=ADJACENCY["GCN"],
                 EvolveGCN=lambda a: _sym_norm(a + np.eye(N)))


def _sym_norm(a):
    """D^-1/2 a D^-1/2 of a dense matrix whose rows all have a sum."""
    d = a.sum(1) ** -0.5
    return d[:, None] * a * d[None, :]


def _driver_window_and_loss(dataset, method, change):
    """The body of the driver checks: inputs and adjacency against the JAX
    driver's and ``ADJACENCY``, the neighbor table where the JAX driver
    builds one, then the U-neg loss and its gradients, the forward given
    no key (no generator), so without dropout and at rrelu's mean slope.
    Degree features (EvolveGCN) are bit-equal: the JAX driver draws them
    from the global ``np.random``, seeded here as the port's ``rng``."""
    _, _, emb = dataset
    conf = dict(emb[method], dropout=0.0, **change)
    jargs, targs = dict(conf), dict(conf)
    jl, tl = JD.get_data_loader(jargs), TD.get_data_loader(targs)
    np.random.seed(8)
    in_j, jadjs, jxs, _ = JD.get_input_data(method, 0, T, jl, jargs)
    in_t, data = TD.get_input_data(method, 0, T, tl, targs,
                                   rng=np.random.RandomState(8))
    assert in_t == in_j
    if jxs is None:
        assert in_t == N and data["xs"] is None
    else:
        np.testing.assert_array_equal(data["xs"].numpy(), np.asarray(jxs))
    jargs["input_dim"] = targs["input_dim"] = in_t
    plans = change.get("adj_backend") == "ell"
    assert (jadjs.ell_fwd is not None) is plans
    raw = tl.get_scipy_adj_list(targs["origin_base_path"], 0, T)
    for t, g in enumerate(data["adjs"]):
        assert g.backend == ("ell" if plans else "segment")
        assert isinstance(g.plan_fwd, EvPlan) is plans
        jg = JS.SparseGraph(rows=jadjs.rows[t], cols=jadjs.cols[t],
                            vals=jadjs.vals[t], n_rows=N, n_cols=N)
        dense = TS.to_dense(g).numpy()
        np.testing.assert_allclose(dense, np.asarray(JS.to_dense(jg)),
                                   rtol=1e-7, atol=1e-7)
        want = ADJACENCY[method](raw[t].toarray())
        np.testing.assert_allclose(dense, want, rtol=1e-6, atol=1e-7)
    jnd = jargs.pop("_neighbor_data", None)
    assert (jnd is None) is (data["neighbor_data"] is None)
    if jnd is not None:
        for k in (0, 1):
            np.testing.assert_array_equal(data["neighbor_data"][k].numpy(),
                                          np.asarray(jnd[k]))

    jmodel = JD.get_gnn_model(method, T, jargs, jax.random.key(5))
    tmodel = _load(TD.get_gnn_model(method, T, targs,
                                    torch.Generator().manual_seed(0)),
                   jmodel)
    if method in ("GIN", "TgGIN"):
        assert tmodel.pooling_type == jmodel.pooling_type == "sum"
        assert tmodel.learn_eps is (method == "TgGIN")
    walk_j = jl.get_walk_data(*_walk_paths(targs), 0, T)
    data["walk"] = tl.get_walk_data(*_walk_paths(targs), 0, T)
    jdata = {"adjs": jadjs, "xs": jxs, "neighbor_data": jnd, "walk": walk_j}
    rng = np.random.default_rng(6)
    b_idx = rng.permutation(N)[:48].astype(np.int32)
    b_mask = np.ones(48, bool)
    b_mask[-3:] = False
    key = jax.random.key(7)
    jfwd = JD.make_forward(method)
    jloss_fn = JD._uneg_loss_fn(lambda m, d, k: jfwd(m, d, None), False, S,
                                Q)
    jval, jgrads = jax.value_and_grad(
        lambda m: jloss_fn(m, jdata, jnp.asarray(b_idx),
                           jnp.asarray(b_mask), key))(jmodel)
    j, neg = _draws(jax.random.split(key)[1], walk_j, b_idx)
    loss = TL.uneg_loss(TD.make_forward(method)(tmodel, data),
                        torch.from_numpy(b_idx).long(),
                        torch.from_numpy(b_mask), data["walk"], j, neg, Q=Q)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=FWD_TOL)
    _check_grads(tmodel, jgrads)


@pytest.mark.parametrize("method", METHODS)
def test_cli_runs_each_method(dataset, tmp_path, method):
    """``--task=embedding`` as the config gives it (duration 1, so two
    windows), one epoch on the CPU: finite losses, the segment SpMM below
    ``ELL_AUTO_NODES`` in every window, one CSV per snapshot, the model
    file."""
    _cli_run(dataset, tmp_path, method)


def _cli_run(dataset, tmp_path, method, **change):
    """The body of the CLI checks, for any method of ``ZOO``, its config
    entry updated with ``change``."""
    base, names, emb = dataset
    conf = dict(emb[method], embed_folder=f"2.embedding/{method}-cli",
                model_file=f"{method}-cli", **change)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {method: conf}}))
    results = cli.main([f"--config={path}", "--task=embedding",
                        f"--method={method}", "--device=cpu"])
    windows = len(range(0, T, conf["duration"]))
    assert [r["core_backend"] for r in results] == ["segment"] * windows
    assert sum(r["time_length"] for r in results) == T
    assert all(np.isfinite(r["losses"]).all() for r in results)
    out = base / "2.embedding" / f"{method}-cli"
    assert sorted(p.name for p in out.iterdir()) == [
        "2010-01.csv", "2010-02.csv"]
    assert (base / conf["model_folder"] / conf["model_file"]).is_file()


@pytest.mark.parametrize("method, change", [
    ("GCRN", {"n_devices": 2}), ("VGRNN", {"remat_policy": "save_spmm"}),
    ("PGNN", {"profile_dir": "prof"}),
    ("GCN", {"remat_policy": "save_spmm"}), ("GCN", {"profile_dir": "prof"})])
def test_unported_zoo_raises(dataset, tmp_path, method, change):
    """The JAX driver's options reach the zoo's trainers: ``remat_policy:
    "save_spmm"`` is accepted and changes nothing for the zoo (the same
    losses as without it, as in the JAX package, whose policy acts only
    on the family), and ``profile_dir`` writes one trace a window.
    ``n_devices`` above 1 (the zoo's time sharding) passes
    ``_check_scope``, which no longer reads the world size
    (``tests/test_torch_zoo_dist.py`` runs it on 2 ranks)."""
    _, _, emb = dataset
    if "n_devices" in change:
        TD._check_scope(method, dict(emb["GCN"], **change))
        return
    if "profile_dir" in change:
        change = {"profile_dir": str(tmp_path / "prof")}
    runs = []
    for tag, keys in (("plain", {}), ("option", change)):
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps({"embedding": {method: dict(
            emb["GCN"], embed_folder=f"2.embedding/{method}-{tag}",
            model_file=f"{method}-{tag}", **keys)}}))
        runs.append(cli.main([f"--config={path}", "--task=embedding",
                              f"--method={method}", "--device=cpu"]))
    assert [r["losses"] for r in runs[1]] == [r["losses"] for r in runs[0]]
    if "profile_dir" in change:
        assert len(list((tmp_path / "prof").iterdir())) == len(runs[1])


def test_dropout_keeps_half_and_doubles_them():
    """Both packages' dropout at rate 0.5 over 10^5 entries: a keep rate
    within 0.5 +- 0.01 (about 6 standard deviations), kept values x2;
    without a generator (a key) nothing is dropped."""
    x = torch.ones(100_000)
    out = t_dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert bool((out[kept] == 2.0).all())
    assert t_dropout(x, 0.5, None) is x
    jout = np.asarray(j_dropout(jnp.ones(100_000), 0.5, jax.random.key(0)))
    assert abs(float((jout != 0).mean()) - 0.5) < 0.01
    assert (jout[jout != 0] == 2.0).all()


#: both packages start each seed from the same parameters, so what
#: differs is the dropout masks, the negatives and the batch order: the
#: per-seed relative gap of the final loss, (torch - jax) / jax, had a
#: standard deviation of 0.035 over seeds 0-7 of this setup on the CPU;
#: over three seeds its mean has a standard error of about 0.020, and may
#: lie at most four of them, LOSS_REL_GAP, from zero
LOSS_REL_GAP = 0.08
STAT_SEEDS, STAT_EPOCHS = (0, 1, 2), 5


def test_gcn_training_loss_matches_jax_statistically(dataset, tmp_path):
    """GCN as configs/uci.json gives it (dropout 0.5, U-neg, lr 1e-3,
    weight decay 5e-4) for STAT_EPOCHS epochs on window 0, seeds 0-2, each
    from the JAX model's initial parameters."""
    _, _, emb = dataset
    args = dict(emb["GCN"], embed_folder="2.embedding/stat", model_file="")
    finals = {"jax": [], "torch": []}
    for seed in STAT_SEEDS:
        jargs = dict(args)
        jl = JD.get_data_loader(jargs)
        _, jadjs, _, _ = JD.get_input_data("GCN", 0, 1, jl, jargs)
        jargs["input_dim"] = N
        jmodel = JD.get_gnn_model("GCN", 1, jargs, jax.random.key(seed))
        targs = dict(args)
        ttrainer = TD.build_trainer("GCN", targs, TD.get_data_loader(targs),
                                    0, 1, torch.device("cpu"),
                                    torch.Generator().manual_seed(seed),
                                    seed=seed)
        # before the JAX step, which donates the model's buffers
        _load(ttrainer.model, jmodel)
        fwd = JD.make_forward("GCN")
        trainer = JUnsupervisedEmbedding(
            base_path=args["base_path"], origin_folder=args["origin_folder"],
            embedding_folder=args["embed_folder"], node_list=jl.full_node_list,
            model=jmodel, loss_fn=JD._uneg_loss_fn(fwd, False, S, Q),
            embed_fn=JD._embed_fn(fwd, "plain"),
            data={"adjs": jadjs, "xs": None, "neighbor_data": None,
                  "walk": jl.get_walk_data(*_walk_paths(jargs), 0, 1)},
            time_length=1)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer.learn_embedding(
                epoch=STAT_EPOCHS, batch_size=args["batch_size"],
                lr=args["lr"], weight_decay=args["weight_decay"],
                model_file=None, export=False, seed=seed)
        losses = [float(v) for v in re.findall(r"loss: (\S+),",
                                               buf.getvalue())]
        assert len(losses) == STAT_EPOCHS
        finals["jax"].append(losses[-1])
        res = ttrainer.learn_embedding(
            epoch=STAT_EPOCHS, batch_size=args["batch_size"], lr=args["lr"],
            weight_decay=args["weight_decay"], model_file=None, export=False,
            seed=seed, verbose=False)
        finals["torch"].append(res["losses"][-1])
    gap = np.mean((np.array(finals["torch"]) - np.array(finals["jax"]))
                  / np.array(finals["jax"]))
    assert abs(gap) <= LOSS_REL_GAP, finals
