# coding: utf-8
"""The non-GNN autoencoders (``ctgcn_torch/nn/dynae.py``: DynGEM, DynAE,
DynRNN, DynAERNN, their losses, trainer and driver) against
``ctgcn_tpu`` on the CPU, from numpy seeds, the JAX parameters carried
over by ``params_from_numpy``.

  * Models on N = 40 nodes, a window of W = 4 weighted snapshots, units
    (16, 12), d = 6, look_back 2: each model's outputs, its loss
    (regularization included, nu1 and nu2 large enough to matter) and
    every parameter gradient within 1e-5 of the largest value (float64
    on the port's side where the CPU's f32 sums lose more).
  * One batch holding every row (``batch_size`` >= rows): 3 epochs of
    ``learn_embedding`` give the JAX package's exported embedding and
    parameters within 1e-4 of their largest value (DynAE, DynRNN,
    DynAERNN).
  * DynGEM over several batches: ``train_epoch`` fed the JAX package's own
    ``jax.random.choice`` draws from its key chain gives its parameters
    after 2 epochs within 1e-4.
  * The sampler: distinct rows within a batch, every row's frequency over
    10^4 draws within 6 standard deviations of uniform, and independent
    batches within an epoch.
  * The driver: the dense window equal to ``toarray``, DynGEM's warm start
    across windows and from a stale file, the refusal of a flax msgpack
    model file, and the CLI for each of the four methods.
"""
import json
import re
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
from ctgcn_torch.nn import dynae as TD
from ctgcn_torch.training.engine import make_optimizer, read_model_file
from ctgcn_tpu.nn import dynae as JD

ROOT = Path(__file__).resolve().parent.parent
N, W, UNITS, D, LB = 40, 4, (16, 12), 6, 2
NAMES = [f"n{i}" for i in range(N)]
FWD_TOL = 1e-5
TRAIN_TOL = 1e-4
BETA, NU1, NU2, ALPHA = 5.0, 1e-2, 1e-2, 0.3
METHODS = ("DynGEM", "DynAE", "DynRNN", "DynAERNN")


def _mats(seed=0, density=0.12):
    """W symmetric snapshots of weights 1-4, no self-loops."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(W):
        a = np.triu((rng.random((N, N)) < density)
                    * rng.integers(1, 5, (N, N)), 1).astype(np.float64)
        out.append(sp.coo_matrix(a + a.T))
    return out


def _window(mats):
    return np.stack([m.toarray().astype(np.float32) for m in mats])


def _jax_model(method, key=1, bias=True):
    k = jax.random.key(key)
    if method == "DynGEM":
        return JD.DynGEM.init(k, N, D, UNITS, bias)
    if method == "DynAE":
        return JD.DynAE.init(k, N, D, LB, UNITS, bias)
    if method == "DynRNN":
        return JD.DynRNN.init(k, N, D, LB, UNITS, bias)
    return JD.DynAERNN.init(k, N, D, LB, UNITS, (10,), bias)


def _torch_model(method, bias=True):
    args = {"embed_dim": D, "bias": bias, "look_back": LB,
            "n_units": UNITS, "ae_units": UNITS, "rnn_units": (10,)}
    return TD.build_model(method, N, args, torch.Generator().manual_seed(0))


def _tree(jtree):
    return jax.tree.map(np.asarray, serialization.to_state_dict(jtree))


def _carry(method, bias=True, key=1):
    """(JAX model, the port's model with its parameters)."""
    jmodel = _jax_model(method, key, bias)
    tmodel = _torch_model(method, bias)
    state = params_from_numpy(_tree(jmodel))
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return jmodel, tmodel


def _close(got, ref, tol, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} over {tol} * {scale:.3e}"


def _check_tree(tmodel_or_grads, jtree, tol, what):
    """Every leaf of ``jtree`` (a JAX parameter or gradient tree) within
    ``tol`` of the largest value of all of them."""
    ref = params_from_numpy(_tree(jtree))
    scale = max(float(v.abs().max()) for v in ref.values())
    got = (tmodel_or_grads if isinstance(tmodel_or_grads, dict)
           else dict(tmodel_or_grads.named_parameters()))
    for name, r in ref.items():
        err = float((got[name].detach().double() - r.double()).abs().max())
        assert err <= tol * scale, (f"{what} {name}: {err:.3e} over {tol} "
                                    f"* {scale:.3e}")


def _jax_batch_loss(method, m, window, b_idx, edges=None):
    """The JAX package's batch loss, its gathers as ``_multi_epoch_fn``
    writes them."""
    if method == "DynGEM":
        rows, cols, vals = (jnp.asarray(a) for a in edges)
        graph = window[0]
        xi, xj = graph[rows[b_idx]], graph[cols[b_idx]]
        hx_i, xi_pred = m(xi)
        hx_j, xj_pred = m(xj)
        return JD.dyngem_loss(
            m, xi_pred, xi, jnp.where(xi != 0, BETA, 1.0), xi.sum(1),
            xj_pred, xj, jnp.where(xj != 0, BETA, 1.0), xj.sum(1), hx_i,
            hx_j, vals[b_idx].astype(jnp.float32), ALPHA, NU1, NU2)
    g, node = b_idx // N, b_idx % N
    x_pre = window[g[:, None] + jnp.arange(LB)[None, :], node[:, None]]
    x_cur = window[g + LB, node]
    x_in = x_pre.reshape(x_pre.shape[0], -1) if method == "DynAE" else x_pre
    _, x_pred = m(x_in)
    return JD.dyngraph2vec_loss(m, x_pred, x_cur,
                                jnp.where(x_cur != 0, BETA, 1.0), NU1, NU2)


def _inputs(method, mats, rng):
    window = _window(mats)
    if method == "DynGEM":
        edges = sp.find(mats[0])
        b_idx = rng.choice(len(edges[0]), 30, replace=False)
        data = (torch.from_numpy(window[0]),
                *(torch.from_numpy(np.asarray(a)) for a in edges))
        data = (data[0], data[1].long(), data[2].long(), data[3].float())
    else:
        edges = None
        b_idx = rng.choice(N * (W - LB), 30, replace=False)
        data = (torch.from_numpy(window),)
    return window, edges, b_idx, data


# --------------------------------------------------------------------------
# (a) models, losses and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method, bias", [
    ("DynGEM", True), ("DynAE", True), ("DynRNN", True), ("DynAERNN", True),
    ("DynRNN", False), ("DynAERNN", False)])
def test_model_forward_loss_and_grads_equal_jax(method, bias):
    """Outputs of the models on the batch's inputs, the batch loss and
    every parameter gradient (the zero LSTM biases' of ``bias: false``
    included: trainable leaves in both packages)."""
    mats = _mats()
    jmodel, tmodel = _carry(method, bias)
    window, edges, b_idx, data = _inputs(method, mats, np.random.default_rng(2))
    jwin = jnp.asarray(window)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda m: _jax_batch_loss(method, m, jwin, jnp.asarray(b_idx),
                                  edges)))(jmodel)
    tmodel = tmodel.double()
    data64 = tuple(d.double() if d.is_floating_point() else d for d in data)
    loss = TD.make_batch_loss(method, LB, ALPHA, BETA, NU1, NU2)(
        tmodel, data64, torch.from_numpy(b_idx))
    loss.backward()
    _close(float(loss.detach()), float(jloss), FWD_TOL, f"{method} loss")
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    _check_tree(grads, jgrads, FWD_TOL, f"{method} grad")
    # the model's outputs on the whole window, as the export embeds
    with torch.no_grad():
        temb = TD.embed(method, LB, tmodel, data64)
    _close(temb.numpy(), _jax_embed(method, jmodel, jwin), FWD_TOL,
           f"{method} embedding")
    if method in ("DynGEM", "DynAE"):
        assert bool((temb >= 0).all())


def _jax_embed(method, jmodel, jwin):
    """The JAX trainer's export: every node from the window's snapshot
    (DynGEM) or its last ``LB`` snapshots."""
    if method == "DynGEM":
        return np.asarray(jmodel(jwin[0])[0])
    x_pre = jnp.swapaxes(jwin[W - LB:], 0, 1)
    if method == "DynAE":
        x_pre = x_pre.reshape(N, -1)
    return np.asarray(jmodel(x_pre)[0])


@pytest.mark.parametrize("method", METHODS)
def test_regularization_counts_two_d_parameters(method):
    """The port's regularization equals the JAX one; it divides by the
    number of 2-D parameters (``Linear`` weights, LSTM ``w_ih``/``w_hh``)
    and nu2 multiplies each Frobenius norm, not its square."""
    jmodel, tmodel = _carry(method)
    two_d = [p for p in tmodel.parameters() if p.ndim == 2]
    expected = {"DynGEM": 6, "DynAE": 6, "DynRNN": 12,
                "DynAERNN": 2 * 3 + 2 * 2 + 3}[method]
    assert len(two_d) == expected
    got = float(TD.regularization_loss(tmodel, NU1, NU2).detach())
    _close(got, float(JD.regularization_loss(jmodel, NU1, NU2)), FWD_TOL,
           method)
    with torch.no_grad():
        by_hand = (NU1 * sum(float(w.abs().sum()) for w in two_d)
                   + NU2 * sum(float(w.norm()) for w in two_d)) / expected
    _close(got, by_hand, FWD_TOL, method)
    assert TD.regularization_loss(tmodel, 0.0, 0.0) == 0.0


def test_relu_mlp_keeps_relu_after_last_layer():
    """``ReluMLP``'s last layer is rectified too, so an encoder whose last
    pre-activations are negative embeds to exact zeros."""
    mlp = TD.ReluMLP(4, 3, (5,))
    with torch.no_grad():
        mlp.layers[-1].bias.fill_(-100.0)
    assert bool((mlp(torch.randn(8, 4)) == 0).all())


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

@pytest.fixture
def dataset(tmp_path):
    """A copy-like artifact tree of W snapshots over N named nodes."""
    base = tmp_path / "data"
    (base / "nodes_set").mkdir(parents=True)
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(NAMES) + "\n")
    (base / "1.format").mkdir()
    for t, m in enumerate(_mats(seed=5)):
        c = sp.triu(m).tocoo()
        (base / "1.format" / f"2011-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"n{a}\tn{b}\t{int(v)}\n"
                for a, b, v in zip(c.row, c.col, c.data)))
    return base


def _trainers(dataset, method, mats, bias=True):
    jmodel, tmodel = _carry(method, bias)
    common = dict(base_path=str(dataset), origin_folder="1.format",
                  node_list=NAMES)
    jt = JD.DynamicEmbedding(embedding_folder="2.embedding/jax",
                             model=jmodel, model_folder="model-jax",
                             **common)
    edge_data = sp.find(mats[0]) if method == "DynGEM" else None
    window = _window(mats)
    tt = TD.DynamicEmbedding(embedding_folder="2.embedding/torch",
                             model=tmodel, method=method, look_back=LB,
                             window=torch.from_numpy(window), device="cpu",
                             edge_data=edge_data, model_folder="model-torch",
                             **common)
    return jt, tt, window, edge_data


def _read_csv(path):
    lines = Path(path).read_text().splitlines()[1:]
    return np.array([[float(v) for v in ln.split("\t")[1:]] for ln in lines])


@pytest.mark.parametrize("method", ["DynAE", "DynRNN", "DynAERNN"])
def test_one_batch_training_equals_jax(dataset, method):
    """With ``batch_size`` >= rows the batch is a permutation of every row
    and each loss a mean over rows, so 3 epochs give the JAX package's
    exported embedding (snapshot ``idx``'s CSV) and parameters within
    1e-4 of their largest values."""
    mats = _mats()
    jt, tt, window, _ = _trainers(dataset, method, mats)
    kw = dict(beta=BETA, nu1=NU1, nu2=NU2, epoch=3, batch_size=4096,
              lr=1e-2, idx=3, model_file=method.lower(), seed=0)
    jt.learn_embedding(jnp.asarray(window), method, LB, alpha=0.0, **kw)
    res = tt.learn_embedding(verbose=False, **kw)
    assert res["batch_num"] == 1 and len(res["losses"]) == 3
    _check_tree(tt.model, jt.model, TRAIN_TOL, f"{method} params")
    jcsv = dataset / "2.embedding" / "jax" / "2011-04.csv"
    tcsv = dataset / "2.embedding" / "torch" / "2011-04.csv"
    _close(_read_csv(tcsv), _read_csv(jcsv), TRAIN_TOL, f"{method} export")
    saved = read_model_file(dataset / "model-torch" / method.lower())
    assert set(saved) == set(tt.model.state_dict())


def _jax_draws(seed, epochs, element_num, batch_size, batch_num):
    """The JAX trainer's batches: its key chain (one chunk of
    ``epochs`` epochs) and per-batch ``choice(replace=False)``."""
    rng = jax.random.key(seed)
    rng, sub = jax.random.split(rng)
    out = []
    for key in jax.random.split(sub, epochs):
        out.append([torch.from_numpy(np.array(jax.random.choice(
            k, element_num, (batch_size,), replace=False))).long()
            for k in jax.random.split(key, batch_num)])
    return out


def test_dyngem_epochs_with_jax_draws_equal_jax(dataset):
    """DynGEM over 4 batches an epoch: ``train_epoch`` fed the JAX
    package's own draws gives the JAX parameters after 2 epochs within
    1e-4, each epoch's summed loss the same."""
    mats = _mats()
    jt, tt, window, edge_data = _trainers(dataset, "DynGEM", mats)
    element_num = len(edge_data[0])
    batch_size = 40
    batch_num = -(-element_num // batch_size)
    assert batch_num >= 4
    jt.learn_embedding(jnp.asarray(window), "DynGEM", 0, BETA, NU1, NU2,
                       alpha=ALPHA, edge_data=edge_data, epoch=2,
                       batch_size=batch_size, lr=1e-2, idx=0,
                       model_file="", seed=7)
    draws = _jax_draws(7, 2, element_num, batch_size, batch_num)
    model = tt.model
    opt = make_optimizer(list(model.parameters()), 1e-2)
    loss = TD.make_batch_loss("DynGEM", 0, ALPHA, BETA, NU1, NU2)
    for batches in draws:
        total = TD.train_epoch(model, opt, loss, tt.data, batches)
        assert np.isfinite(float(total))
    _check_tree(model, jt.model, TRAIN_TOL, "DynGEM params")


def test_sampler_is_uniform_without_replacement():
    """Each batch holds distinct rows; over 10^4 single-batch draws of 20
    of 50 rows every row's count lies within 6 standard deviations of
    4,000; two batches of one epoch overlap (independent samples)."""
    gen = torch.Generator().manual_seed(0)
    rows, size, draws = 50, 20, 10_000
    counts = np.zeros(rows)
    overlaps = 0
    for _ in range(draws // 2):
        a, b = TD.draw_batches(rows, size, 2, gen)
        for batch in (a, b):
            assert len(set(batch.tolist())) == size
            counts += np.bincount(batch.numpy(), minlength=rows)
        overlaps += len(set(a.tolist()) & set(b.tolist())) > 0
    p = size / rows
    sd = np.sqrt(draws * p * (1 - p))
    assert np.abs(counts - draws * p).max() < 6 * sd
    assert overlaps > 0.9 * (draws // 2)
    full = TD.draw_batches(rows, rows, 1, gen)[0]
    assert sorted(full.tolist()) == list(range(rows))


def test_dense_window_equals_toarray():
    """The window built on the device from each COO equals ``toarray``,
    duplicate entries summed."""
    mats = _mats()
    dup = sp.coo_matrix((np.array([1.5, 2.25, 1.0]),
                         (np.array([0, 0, 3]), np.array([1, 1, 2]))),
                        shape=(N, N))
    mats = mats[:-1] + [dup]
    got = TD.dense_window(mats, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), _window(mats))
    assert float(got[-1, 0, 1]) == 3.75


# --------------------------------------------------------------------------
# the driver and the CLI
# --------------------------------------------------------------------------

def _config(dataset, method, **change):
    with open(ROOT / "configs" / "uci.json") as fp:
        emb = json.load(fp)["embedding"][method]
    emb = dict(emb, base_path=str(dataset), embed_dim=D, epoch=2,
               batch_size=64, record_time=False)
    if method == "DynAERNN":
        emb.update(ae_units=list(UNITS), rnn_units=[10])
    elif method != "TIMERS":
        emb["n_units"] = list(UNITS)
    emb.update(change)
    return emb


def _run_cli(dataset, tmp_path, method, **change):
    emb = _config(dataset, method, **change)
    path = tmp_path / f"{method}.json"
    path.write_text(json.dumps({"embedding": {method: emb}}))
    return emb, cli.main([f"--config={path}", "--task=embedding",
                          f"--method={method}", "--device=cpu"])


def test_dyngem_warm_start_loads_the_last_saved_parameters(
        dataset, tmp_path, monkeypatch):
    """With ``load_model`` window 1 starts from window 0's saved
    parameters, and a second run's window 0 from the first run's last
    file (a stale file is read as it is, as in the JAX package)."""
    saved, loaded = [], []
    real_save, real_load = TD.save_model_file, TD.load_model_file

    def save(model, path):
        saved.append({k: v.clone() for k, v in model.state_dict().items()})
        real_save(model, path)

    def load(model, path, device):
        real_load(model, path, device)
        loaded.append({k: v.clone() for k, v in model.state_dict().items()})

    monkeypatch.setattr(TD, "save_model_file", save)
    monkeypatch.setattr(TD, "load_model_file", load)
    for _ in range(2):
        _run_cli(dataset, tmp_path, "DynGEM", end_idx=1, load_model=True)
    assert len(saved) == 4 and len(loaded) == 3
    for got, want in zip(loaded, saved[:3]):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_flax_model_file_raises_naming_the_path(dataset, tmp_path):
    """A model file that is neither a ``torch.save`` archive nor flax
    msgpack (here a flax file cut short) at the warm-start path raises,
    naming the path, and no fresh model is trained instead; a whole
    JAX-written file loads (``tests/test_torch_model_file.py``)."""
    emb = _config(dataset, "DynGEM")
    path = dataset / emb["model_folder"] / emb["model_file"]
    path.parent.mkdir(parents=True, exist_ok=True)
    jmodel = _jax_model("DynGEM")
    path.write_bytes(serialization.to_bytes(jmodel)[:-7])
    with pytest.raises(ValueError,
                       match=re.escape(str(path)) + ".*not a model file"):
        _run_cli(dataset, tmp_path, "DynGEM", load_model=True)
    assert not (dataset / emb["embed_folder"]).exists() or not any(
        (dataset / emb["embed_folder"]).iterdir())
    path.unlink()


@pytest.mark.parametrize("method", METHODS)
def test_cli_runs_each_method(dataset, tmp_path, method):
    """``--task=embedding --method=M --device cpu`` on the config's entry
    (narrowed): one CSV per window holding every node, finite losses,
    the model file, the recorded times."""
    emb, results = _run_cli(dataset, tmp_path, method, record_time=True)
    first = 0 if method == "DynGEM" else emb["start_idx"]
    idxs = list(range(first, W))
    assert [r["idx"] for r in results] == idxs
    assert all(r["core_backend"] == "dense" and len(r["losses"]) == 2
               and np.isfinite(r["losses"]).all() for r in results)
    out = dataset / emb["embed_folder"]
    files = sorted(p.name for p in out.iterdir())
    assert files == [f"2011-0{i + 1}.csv" for i in idxs]
    for f in files:
        arr = _read_csv(out / f)
        assert arr.shape == (N, D) and np.isfinite(arr).all()
        assert (arr >= 0).all() or method in ("DynRNN", "DynAERNN")
    assert (dataset / emb["model_folder"] / emb["model_file"]).is_file()
    times = (dataset / f"{method}_time.csv").read_text().splitlines()
    assert times[0] == "time" and len(times) == len(idxs) + 1


def test_driver_checks_its_windows(dataset):
    """DynGEM embeds one snapshot, and a window must hold more snapshots
    than its look-back."""
    with pytest.raises(ValueError, match="duration 1"):
        TD.dyngem_embedding("DynGEM", _config(dataset, "DynGEM",
                                              duration=2, start_idx=1),
                            device="cpu")
    with pytest.raises(ValueError, match="look_back"):
        TD.dyngem_embedding("DynAE", _config(dataset, "DynAE", look_back=3),
                            device="cpu")
    with pytest.raises(ValueError, match="not one of"):
        TD.dyngem_embedding("TIMERS", {}, device="cpu")
