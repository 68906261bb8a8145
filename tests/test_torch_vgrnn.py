# coding: utf-8
"""The zoo's VGRNN (``ctgcn_torch/nn/vgrnn.py``, ``losses.vae_loss`` and
the engine's stateful protocol) against ``ctgcn_tpu`` on the CPU, from
numpy seeds, the JAX parameters carried over by ``params_from_numpy``.

  * Modules on N = 48 nodes, T = 3 snapshots of weights 1-4 (so the VAE
    loss's posw and norm, which come from the sum of weights, differ from
    an edge count's), hid 12, embed 8: ``GraphConv`` (GCN, SAGE, GIN),
    ``GraphGRU`` (two layers) and ``VGRNN`` (identity and given features,
    each conv type, the segment SpMM and the kernels' plans, their plain
    versions here), forward within 1e-5 (rtol and atol), parameter
    gradients within 1e-4 of the value plus 1e-4 of the largest gradient
    (the zoo's tolerances).  The noise is the JAX model's own draws
    (``jax.random.normal`` of ``split(key, T)``), passed to the port as
    ``noise``.
  * ``vae_loss`` from the same inputs against the JAX ``vae_loss`` on
    z z^T and the dense target: value within 1e-5 relative, input and
    parameter gradients as above; the dense softplus sum's autograd
    Function by ``gradcheck`` in float64, whole and in row chunks; no
    tensor of N^2 elements saved for the loss's backward.
  * The stateful engine with batch_size < N: the per-epoch losses of 3
    epochs of 3 batches against the JAX ``_single_epoch_step`` with
    ``state_init`` (its noise injected), and the export's replay of the
    carry against ``_embed_fn_stateful``'s chain with ``key(0)``'s noise,
    within 1e-4; each batch's state the previous batch's h, detached, and
    zeros at each epoch start.
  * The driver, on the zoo's generated dataset (``tests/test_torch_zoo.py``:
    N = 120, two weighted snapshots): VGRNN's two graphs against the JAX
    driver's, the traps (the factory's dropped ``rnn_layer_num``, the
    same noise at every export call), the U-own and U-neg losses against
    the JAX driver's, and the CLI under both.
  * Against the benchmark's plain reference (``gpubench/reference/
    vgrnn.py``, loaded by path), N = 200, T 3, hid 16, embed 8, 5 Gram
    chunks a side, seeded weights and noise: enc_mean and z at each
    snapshot, the loss of two batches that carry h, every leaf's gradient
    over both and an Adam step, each within a tolerance whose reason is
    given beside it; z rounded to bf16 before the Gram fails the loss and
    the gradients.  ``_noise`` bit-equal to the inline draw it replaced;
    the VAE loss's ``loss`` and ``gram`` spans and its ``vae.*`` counters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.nn import functional as F

from ctgcn_torch import losses as TL
from ctgcn_torch.data.loader import DataLoader as TDataLoader
from ctgcn_torch.nn import vgrnn as TV
from ctgcn_torch.ops import sparse as TS
from ctgcn_torch.ops.ell import EvPlan
from ctgcn_torch.training import driver as TD
from ctgcn_torch.training import engine as TE
from ctgcn_tpu import losses as JL
from ctgcn_tpu.data.loader import stack_graphs
from ctgcn_tpu.nn import vgrnn as JV
from ctgcn_tpu.ops import sparse as JS
from ctgcn_tpu.training import driver as JD
from ctgcn_tpu.training import engine as JE
from tests.test_torch_ctgcn import Q, S
from tests.test_torch_zoo import (FWD_TOL, GRAD_TOL, _check_grads, _cli_run,
                                  _draws, _load, _tree, _walk_paths,
                                  dataset)  # noqa: F401
from tests.test_torch_zoo import EMB as ZOO_EMB
from tests.test_torch_zoo import N as ZOO_N
from tests.test_torch_zoo import T as ZOO_T

N, T, HID, EMB, FEAT = 48, 3, 12, 8, 10
EPS = 1e-10
NAMES = [f"u{i}" for i in range(N)]


def _mats(seed=0, density=0.08):
    """T symmetric snapshots of weights 1-4, no self-loops."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(T):
        a = np.triu((rng.random((N, N)) < density)
                    * rng.integers(1, 5, (N, N)), 1).astype(np.float64)
        out.append(sp.coo_matrix(a + a.T))
    return out


def _window(backend="segment", seed=0, density=0.08):
    """(port convolution graphs, port targets, JAX normalized bank, JAX
    dense targets [T, N, N]) of ``_mats``."""
    mats = _mats(seed, density)
    normed = [TD._vgrnn_norm(m) for m in mats]
    loader = TDataLoader(NAMES, T)
    bank = stack_graphs([JS.from_scipy(m, pad_to=1024) for m in normed])
    dense = jnp.asarray(np.stack([m.toarray() for m in mats]), jnp.float32)
    return (loader.graphs_from_scipy(normed, adj_backend=backend),
            loader.graphs_from_scipy(mats, adj_backend="segment"), bank,
            dense)


def _noise(key, n=N, t=T, d=EMB):
    """The noise the JAX model draws from ``key``: a normal [n, d] from
    each key of ``split(key, t)``."""
    return [torch.from_numpy(np.array(jax.random.normal(k, (n, d))))
            for k in jax.random.split(key, t)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _compare(jmodel, tmodel, jcall, tcall):
    """Outputs and parameter gradients of sum(tanh(out) * w), ``jcall`` /
    ``tcall`` returning a tuple of arrays."""
    jouts = jcall(jmodel)
    ws = [_normal(20 + i, *o.shape) for i, o in enumerate(jouts)]

    def jloss(m):
        return sum(jnp.sum(jnp.tanh(o) * w) for o, w in zip(jcall(m), ws))

    jgrads = jax.grad(jloss)(jmodel)
    touts = tcall(tmodel)
    sum((torch.tanh(o) * torch.from_numpy(w)).sum()
        for o, w in zip(touts, ws)).backward()
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(tmodel, jgrads)


@pytest.mark.parametrize("conv_type, backend, bias", [
    ("GCN", "segment", True), ("GCN", "ell", True), ("GCN", "segment", False),
    ("SAGE", "segment", True), ("SAGE", "ell", False),
    ("GIN", "segment", True), ("GIN", "ell", True)])
def test_graph_conv_equals_jax(conv_type, backend, bias):
    """act(conv(x)) with ReLU: GCN adds its bias after the SpMM, SAGE
    applies the activation before it, GIN adds x to the neighbour sum."""
    tg, _, bank, _ = _window(backend)
    jadj = jax.tree.map(lambda a: a[0], bank)
    x = _normal(1, N, FEAT)
    jconv = JV.GraphConv.init(jax.random.key(1), FEAT, HID, conv_type, bias)
    tconv = _load(TV.GraphConv(FEAT, HID, conv_type, bias), jconv)
    _compare(jconv, tconv,
             lambda m: (m(jnp.asarray(x), jadj, act=jax.nn.relu),),
             lambda m: (m(torch.from_numpy(x), tg[0], act=F.relu),))


def test_graph_conv_init_follows_the_jax_rule():
    """GCN: glorot weight, zero bias; SAGE and GIN: weight and bias
    U(+-1/sqrt(in)); the same bounds in both packages (10^4 draws reach
    within 1 % of them)."""
    din, dout = 100, 100
    gen = torch.Generator().manual_seed(0)
    for conv_type, bound in (("GCN", np.sqrt(6.0 / (din + dout))),
                             ("SAGE", 1.0 / np.sqrt(din)),
                             ("GIN", 1.0 / np.sqrt(din))):
        tconv = TV.GraphConv(din, dout, conv_type, True, generator=gen)
        jconv = JV.GraphConv.init(jax.random.key(2), din, dout, conv_type,
                                  True)
        for w in (tconv.weight.detach().numpy(), np.asarray(jconv.weight)):
            assert 0.99 * bound < np.abs(w).max() <= bound
        for b in (tconv.bias.detach().numpy(), np.asarray(jconv.bias)):
            if conv_type == "GCN":
                assert not b.any()
            else:
                assert 0.9 * bound < np.abs(b).max() <= bound
    with pytest.raises(ValueError, match="conv_type"):
        TV.GraphConv(4, 4, "GAT")


def test_graph_gru_equals_jax():
    """Two layers of six GCN convolutions: z, r, h~ and z h + (1 - z) h~."""
    tg, _, bank, _ = _window()
    jadj = jax.tree.map(lambda a: a[1], bank)
    inp, h = _normal(2, N, 2 * HID), _normal(3, 2, N, HID)
    jgru = JV.GraphGRU.init(jax.random.key(3), 2 * HID, HID, 2)
    tgru = _load(TV.GraphGRU(2 * HID, HID, 2), jgru)
    _compare(jgru, tgru,
             lambda m: (m(jnp.asarray(inp), jadj, jnp.asarray(h)),),
             lambda m: (m(torch.from_numpy(inp), tg[1],
                          torch.from_numpy(h)),))


@pytest.mark.parametrize("conv_type, backend, features, hx", [
    ("GCN", "segment", False, False), ("GCN", "ell", True, True),
    ("SAGE", "segment", False, True), ("GIN", "ell", True, False)])
def test_vgrnn_forward_equals_jax(conv_type, backend, features, hx):
    """enc_mean, enc_std, the prior's mean and std, z (the JAX decoder is
    z z^T) and h, from zeros or a given hx, the JAX noise injected."""
    tg, _, bank, _ = _window(backend)
    in_dim = FEAT if features else N
    xs = _normal(4, T, N, FEAT) if features else None
    h0 = _normal(5, 1, N, HID) if hx else None
    key = jax.random.key(4)
    noise = _noise(key)
    jmodel = JV.VGRNN.init(jax.random.key(5), in_dim, HID, EMB,
                           conv_type=conv_type)
    tmodel = _load(TV.VGRNN(in_dim, HID, EMB, conv_type=conv_type), jmodel)

    def jcall(m):
        em, h, (_, es, pm, ps, dec) = m(
            None if xs is None else jnp.asarray(xs), bank,
            hx=None if h0 is None else jnp.asarray(h0), key=key)
        return em, es, pm, ps, h, dec

    def tcall(m):
        em, h, (_, es, pm, ps, z) = m(
            None if xs is None else torch.from_numpy(xs), tg,
            hx=None if h0 is None else torch.from_numpy(h0), noise=noise)
        # z against the JAX forward's z = enc_mean + eps * enc_std
        np.testing.assert_allclose(
            z.detach().numpy(),
            (em + torch.stack(noise) * es).detach().numpy(), rtol=0,
            atol=0)
        return em, es, pm, ps, h, z @ z.transpose(1, 2)

    _compare(jmodel, tmodel, jcall, tcall)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    em, pm, z = (rng.standard_normal((T, N, EMB)).astype(np.float32)
                 for _ in range(3))
    es, ps = (np.log1p(np.exp(rng.standard_normal((T, N, EMB))))
              .astype(np.float32) for _ in range(2))
    return em, es, pm, ps, z


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weights-1-4", "unit-weights"])
def test_vae_loss_equals_jax(weighted):
    """Value and the gradients in all five inputs, against the JAX loss on
    z z^T and the dense target; with weights 1-4 posw and norm come from
    their sum."""
    _, targets, _, dense = _window()
    if not weighted:
        targets = tuple(TS.from_scipy(TS.to_scipy(g) != 0) for g in targets)
        dense = (dense != 0).astype(jnp.float32)
    inputs = _loss_inputs(6)

    def jloss(em, es, pm, ps, z):
        dec = jnp.einsum("tnd,tmd->tnm", z, z)
        return JL.vae_loss(em, es, pm, ps, dec, dense, eps=EPS)

    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, inputs))
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    loss = TL.vae_loss(*tin, targets, eps=EPS)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=FWD_TOL)
    for name, got, want in zip(("em", "es", "pm", "ps", "z"), tin, jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("chunk_elems", [None, 8], ids=["whole", "chunks"])
def test_softplus_gram_sum_gradcheck(monkeypatch, chunk_elems):
    """The dense softplus sum's Function in float64: the value of the
    formed sum, and ``gradcheck`` of its backward, in one chunk and in
    chunks of one row."""
    if chunk_elems is not None:
        monkeypatch.setattr(TL, "GRAM_CHUNK_ELEMS", chunk_elems)
        assert len(TL._row_chunks(7)) == 7
    z = torch.randn(7, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    torch.testing.assert_close(TL.softplus_gram_sum(z),
                               F.softplus(z @ z.T).sum())
    assert torch.autograd.gradcheck(TL.softplus_gram_sum, (z,))


def test_vae_loss_saves_no_n_squared_tensor():
    """Through the VGRNN forward and the loss, no tensor saved for the
    backward has N^2 elements or more (the decoder's logits, the dense
    target), where the plain softplus(z z^T) would save one."""
    tg, targets, _, _ = _window(density=0.02)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    z = torch.randn(N, EMB, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        F.softplus(z @ z.T).sum()
    assert max(sizes) >= N * N
    sizes.clear()
    model = TV.VGRNN(N, HID, EMB, generator=torch.Generator().manual_seed(0))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        em, _, (_, es, pm, ps, z) = model(None, tg)
        loss = TL.vae_loss(em, es, pm, ps, z, targets)
    loss.backward()
    assert sizes and max(sizes) < N * N


def test_driver_loss_fn_equals_jax():
    """The driver's stateful U-own loss (the model's forward from a given
    hx and the VAE loss against the weighted target), value, h and
    parameter gradients, against the JAX driver's with the same noise."""
    tg, targets, bank, dense = _window("ell")
    h0 = _normal(7, 1, N, HID)
    key = jax.random.key(8)
    jmodel = JV.VGRNN.init(jax.random.key(9), N, HID, EMB)
    tmodel = _load(TV.VGRNN(N, HID, EMB), jmodel)
    jdata = {"xs": None, "vgrnn_adjs": bank, "vae_adj_dense": dense}
    jloss_fn = JD._vae_loss_fn_stateful(JD.make_forward("VGRNN"), EPS)
    (jval, jh), jgrads = jax.value_and_grad(
        lambda m: jloss_fn(m, jdata, None, None, key, jnp.asarray(h0)),
        has_aux=True)(jmodel)
    loss_fn = TD._vae_loss_fn_stateful(
        functools.partial(TD._vgrnn_forward, noise=_noise(key)), EPS)
    loss, h = loss_fn(tmodel, {"xs": None, "vgrnn_adjs": tg,
                               "adjs": targets}, None, None, None,
                      torch.from_numpy(h0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=FWD_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(tmodel, jgrads)


def _trainer(tmp_path, model, loss_fn, embed_state_fn, data):
    origin = tmp_path / "origin"
    origin.mkdir(exist_ok=True)
    for t in range(T):
        (origin / f"t{t}.csv").touch()
    return TE.UnsupervisedEmbedding(
        base_path=str(tmp_path), origin_folder="origin",
        embedding_folder="emb", node_list=NAMES, model=model,
        loss_fn=loss_fn, embed_fn=None, data=data, device="cpu",
        state_init=TD._vgrnn_state_init, embed_state_fn=embed_state_fn)


EPOCHS, BATCH, LR, WD = 3, 16, 1e-2, 5e-4


def test_stateful_epochs_and_export_equal_jax(tmp_path, monkeypatch):
    """3 epochs of 3 batches: the per-epoch losses (each batch the whole
    window's VAE loss from the carried h) against the JAX
    ``_single_epoch_step`` with ``state_init``, its noise injected; then
    the export's replay of the carry (3 forwards from hx = None) against
    ``_embed_fn_stateful``'s chain, which draws from ``key(0)`` at every
    call; both within 1e-4."""
    tg, targets, bank, dense = _window()
    nb = -(-N // BATCH)
    jmodel = JV.VGRNN.init(jax.random.key(10), N, HID, EMB)
    # before the JAX step, which donates the model's buffers
    tmodel = _load(TV.VGRNN(N, HID, EMB), jmodel)
    jdata = {"xs": None, "vgrnn_adjs": bank, "vae_adj_dense": dense}
    fwd = JD.make_forward("VGRNN")
    step = JE._single_epoch_step(JD._vae_loss_fn_stateful(fwd, EPS), LR, WD,
                                 JD._vgrnn_state_init())
    opt_state = JE.make_optimizer(LR, WD).init(jmodel)
    batches, masks = JE.batch_matrix(N, BATCH, shuffle=False)
    epoch_keys = jax.random.split(jax.random.key(11), EPOCHS)
    jlosses = []
    for k in epoch_keys:
        jmodel, opt_state, loss = step(jmodel, opt_state, jdata,
                                       jnp.asarray(batches),
                                       jnp.asarray(masks), k)
        jlosses.append(float(loss))
    hx = None
    for _ in range(nb):
        jout, hx = JD._embed_fn_stateful(fwd)(jmodel, jdata, hx)

    # batch b of an epoch forwards with key split(epoch key, nb)[b]
    noise = iter([_noise(k) for e in epoch_keys
                  for k in jax.random.split(e, nb)])
    export_noise = _noise(jax.random.key(0))

    def train_fwd(m, d, generator=None, hx=None):
        return TD._vgrnn_forward(m, d, hx=hx, noise=next(noise))

    trainer = _trainer(
        tmp_path, tmodel, TD._vae_loss_fn_stateful(train_fwd, EPS),
        TD._embed_fn_stateful(functools.partial(TD._vgrnn_forward,
                                                noise=export_noise)),
        {"xs": None, "vgrnn_adjs": tg, "adjs": targets})
    exported = []
    monkeypatch.setattr(trainer, "save_embedding",
                        lambda out, start: exported.append(out))
    res = trainer.learn_embedding(epoch=EPOCHS, batch_size=BATCH, lr=LR,
                                  weight_decay=WD, model_file=None,
                                  shuffle=False, verbose=False)
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(exported[0].numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4)


def test_carry_crosses_batches_detached_and_resets_each_epoch(tmp_path):
    """Each batch's state is the batch before's h, detached (no graph, so
    one backward a batch), and zeros at each epoch's first batch."""
    tg, targets, _, _ = _window()
    inner = TD._vae_loss_fn_stateful(TD._vgrnn_forward, EPS)
    seen = []

    def spy(m, d, b_idx, b_mask, generator, hx):
        loss, h = inner(m, d, b_idx, b_mask, generator, hx)
        seen.append((hx, h))
        return loss, h

    model = TV.VGRNN(N, HID, EMB, generator=torch.Generator().manual_seed(1))
    trainer = _trainer(tmp_path, model, spy, TD._embed_fn_stateful(
        TD._vgrnn_forward), {"xs": None, "vgrnn_adjs": tg, "adjs": targets})
    trainer.learn_embedding(epoch=2, batch_size=BATCH, model_file=None,
                            export=False, verbose=False)
    nb = -(-N // BATCH)
    assert len(seen) == 2 * nb
    for i, (hx, h) in enumerate(seen):
        assert hx.grad_fn is None and not hx.requires_grad
        assert h.grad_fn is not None
        if i % nb == 0:
            assert not hx.any()
        else:
            torch.testing.assert_close(hx, seen[i - 1][1].detach(), rtol=0,
                                       atol=0)


@pytest.mark.parametrize("rnn_layer_num, bias", [(1, True), (2, False)])
def test_params_from_numpy_maps_the_vgrnn_tree(rnn_layer_num, bias):
    """``phi_x``, ``phi_z``, ``prior*`` (Linear), ``enc*`` (GraphConv) and
    ``rnn.{xz,hz,xr,hr,xh,hh}.<layer>``, each leaf as it is."""
    jmodel = JV.VGRNN.init(jax.random.key(12), N, HID, EMB,
                           rnn_layer_num=rnn_layer_num, bias=bias)
    tmodel = _load(TV.VGRNN(N, HID, EMB, rnn_layer_num=rnn_layer_num,
                            bias=bias), jmodel)
    tree = _tree(jmodel)
    for name, val in tmodel.state_dict().items():
        leaf = tree
        for part in name.split("."):
            leaf = leaf[part]
        np.testing.assert_array_equal(val.numpy(), leaf, err_msg=name)
    assert len(tmodel.rnn.hh) == rnn_layer_num
    assert (tmodel.enc.bias is None) is (not bias)


def _sym_norm2(a):
    """D^-1/2 (A_bin + 2I) D^-1/2 of a dense raw matrix."""
    b = (a != 0) + 2.0 * np.eye(a.shape[0])
    d = b.sum(1) ** -0.5
    return d[:, None] * b * d[None, :]


def _driver_window(dataset, adj_backend):
    """Both drivers' VGRNN window and model (the JAX one drawn from
    ``key(5)``, carried to the port) on the zoo's dataset, with the config
    giving ``rnn_layer_num: 3``; returns (JAX model, JAX normalized bank,
    JAX raw bank, port model, port window, port args, loaders)."""
    _, _, emb = dataset
    conf = dict(emb["VGRNN"], adj_backend=adj_backend, rnn_layer_num=3)
    jargs, targs = dict(conf), dict(conf)
    jl, tl = JD.get_data_loader(jargs), TD.get_data_loader(targs)
    in_j, jadjs, jxs, _ = JD.get_input_data("VGRNN", 0, ZOO_T, jl, jargs)
    in_t, data = TD.get_input_data("VGRNN", 0, ZOO_T, tl, targs)
    assert in_t == in_j == ZOO_N and jxs is None and data["xs"] is None
    jargs["input_dim"] = targs["input_dim"] = ZOO_N
    jmodel = JD.get_gnn_model("VGRNN", ZOO_T, jargs, jax.random.key(5))
    tmodel = _load(TD.get_gnn_model("VGRNN", ZOO_T, targs,
                                    torch.Generator().manual_seed(0)),
                   jmodel)
    return (jmodel, jargs["_vgrnn_norm_adjs"], jadjs, tmodel, data, targs,
            (jl, tl))


@pytest.mark.parametrize("adj_backend", ["segment", "ell"])
def test_driver_window_and_model_equal_jax(dataset, adj_backend):
    """Both drivers' VGRNN window on the zoo's dataset: the convolutions'
    D^-1/2 (A_bin + 2I) D^-1/2 (with ``EvPlan``s under "ell"), the raw
    weighted target (no plans), identity features; the model from widths,
    ``conv_type`` and ``bias`` only (``rnn_layer_num: 3`` is dropped)."""
    jmodel, jnorm, jadjs, tmodel, data, targs, (_, tl) = _driver_window(
        dataset, adj_backend)
    raw = tl.get_scipy_adj_list(targs["origin_base_path"], 0, ZOO_T)
    for t in range(ZOO_T):
        g, target = data["vgrnn_adjs"][t], data["adjs"][t]
        assert g.backend == ("ell" if adj_backend == "ell" else "segment")
        assert isinstance(g.plan_fwd, EvPlan) is (adj_backend == "ell")
        assert target.backend == "segment"
        jg = jax.tree.map(lambda a: a[t], jnorm)
        np.testing.assert_allclose(TS.to_dense(g).numpy(),
                                   np.asarray(JS.to_dense(jg)), rtol=1e-7,
                                   atol=1e-7)
        np.testing.assert_allclose(TS.to_dense(g).numpy(),
                                   _sym_norm2(raw[t].toarray()), rtol=1e-6,
                                   atol=1e-7)
        jt = jax.tree.map(lambda a: a[t], jadjs)
        np.testing.assert_array_equal(TS.to_dense(target).numpy(),
                                      np.asarray(JS.to_dense(jt)))
        assert TS.to_dense(target).numpy().max() > 1
    assert TD._adj_backend(data) == g.backend
    assert tmodel.rnn_layer_num == jmodel.rnn_layer_num == 1
    assert len(tmodel.rnn.xz) == 1


def test_driver_losses_equal_jax(dataset):
    """On the "ell" window (the Math path's): the driver's U-own loss of
    window 0 from zeros, value and gradients, against the JAX driver's;
    then the U-neg loss of a batch against the JAX
    ``_uneg_loss_fn_stateful`` (the forward's noise from the first half of
    the key, the sampler's draws from the second)."""
    jmodel, jnorm, jadjs, tmodel, data, targs, (jl, tl) = _driver_window(
        dataset, "ell")
    fwd = JD.make_forward("VGRNN")
    jdata = {"xs": None, "vgrnn_adjs": jnorm,
             "vae_adj_dense": JD._vgrnn_dense_bank(jadjs)}
    key = jax.random.key(7)
    jhx = JD._vgrnn_state_init()(jmodel, jdata)
    (jval, _), jgrads = jax.value_and_grad(
        lambda m: JD._vae_loss_fn_stateful(fwd, EPS)(
            m, jdata, None, None, key, jhx), has_aux=True)(jmodel)
    tfwd = functools.partial(TD._vgrnn_forward,
                             noise=_noise(key, ZOO_N, ZOO_T, ZOO_EMB))
    hx = TD._vgrnn_state_init(tmodel, data)
    assert hx.shape == (1, ZOO_N, targs["hid_dim"]) and not hx.any()
    loss, _ = TD._vae_loss_fn_stateful(tfwd, EPS)(tmodel, data, None, None,
                                                 None, hx)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=FWD_TOL)
    _check_grads(tmodel, jgrads)

    tmodel.zero_grad()
    jdata["walk"] = walk_j = jl.get_walk_data(*_walk_paths(targs), 0, ZOO_T)
    data["walk"] = tl.get_walk_data(*_walk_paths(targs), 0, ZOO_T)
    b_idx = np.random.default_rng(6).permutation(ZOO_N)[:48].astype(np.int32)
    b_mask = np.ones(48, bool)
    b_mask[-3:] = False
    (jval, _), jgrads = jax.value_and_grad(
        lambda m: JD._uneg_loss_fn_stateful(fwd, S, Q)(
            m, jdata, jnp.asarray(b_idx), jnp.asarray(b_mask), key, jhx),
        has_aux=True)(jmodel)
    k_drop, k_samp = jax.random.split(key)
    j, neg = _draws(k_samp, walk_j, b_idx)
    embs, _, _ = TD._vgrnn_forward(tmodel, data, hx=hx,
                                   noise=_noise(k_drop, ZOO_N, ZOO_T,
                                                ZOO_EMB))
    loss = TL.uneg_loss(embs, torch.from_numpy(b_idx).long(),
                        torch.from_numpy(b_mask), data["walk"], j, neg, Q=Q)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=FWD_TOL)
    _check_grads(tmodel, jgrads)


def test_trainer_exports_the_same_noise_every_call(dataset):
    """The driver's VGRNN trainer: its export without a generator draws
    from a generator seeded 0 at every call (the JAX export's ``key(0)``),
    so two calls agree, and the one-batch export equals the first step of
    the replay; the U-neg loss returns the forward's h."""
    _, _, emb = dataset
    args = dict(emb["VGRNN"], learning_type="U-neg", Q=Q)
    trainer = TD.build_trainer("VGRNN", args, TD.get_data_loader(args), 0,
                               ZOO_T, torch.device("cpu"),
                               torch.Generator().manual_seed(0))
    m, d = trainer.model, trainer.data
    with torch.no_grad():
        first = trainer.embed_fn(m, d)
        torch.testing.assert_close(trainer.embed_fn(m, d), first, rtol=0,
                                   atol=0)
        torch.testing.assert_close(trainer.embed_state_fn(m, d, None)[0],
                                   first, rtol=0, atol=0)
        loss, h = trainer.loss_fn(
            m, d, torch.arange(10), torch.ones(10, dtype=torch.bool),
            torch.Generator().manual_seed(3), trainer.state_init(m, d))
    assert np.isfinite(loss.item()) and h.shape == (1, ZOO_N,
                                                     args["hid_dim"])


@pytest.mark.parametrize("learning_type", ["U-own", "U-neg"])
def test_cli_runs_vgrnn(dataset, tmp_path, learning_type):
    """configs/uci.json's VGRNN entry at test width (duration 7, so one
    window of both snapshots; batch 50 of 120 nodes, so the carry and the
    export's replay run), one epoch on the CPU: finite losses, one CSV per
    snapshot, the model file."""
    _cli_run(dataset, tmp_path, "VGRNN", learning_type=learning_type, Q=Q)


# ---- the benchmark's plain reference (``gpubench/reference/vgrnn.py``) ----

REF_N, REF_T, REF_HID, REF_EMB = 200, 3, 16, 8
#: rows of z z^T a chunk, on both sides: 5 chunks of N = 200 (the last 8)
REF_ROWS = 48
REF_LR, REF_WD = 1e-3, 5e-4
#: forward (enc_mean, z) within 1e-5 of the value plus 1e-6 of the largest:
#: float32 through the same GEMMs, the SpMMs' sums in another order (the
#: segment sum against ``index_add``), 1-2 ulps a step over 3 steps
REF_FWD = (1e-5, 1e-6)
#: the loss within 2e-6 relative: its N^2 = 40,000 pairs summed as softplus
#: sums and an SDDMM against the reference's dense BCE, each about 1e-7
REF_LOSS = 2e-6
#: each leaf's gradient within 1e-4 of the value plus 1e-5 of its largest
#: entry: backward in float32 through three snapshots, the Gram's backward
#: 2 sigmoid(z z^T) z against autograd's two products (G z and G^T z)
REF_GRAD = (1e-4, 1e-5)
#: the parameters after one Adam step within 1e-6 (an entry moves by about
#: lr = 1e-3 whatever its gradient: 1e-3 of the step's size)
REF_STEP = 1e-6


def _reference_vgrnn():
    """``gpubench/reference/vgrnn.py``, loaded by path (its imports are
    ``gpubench/reference``'s own).  ``gpubench`` is on the path only while
    it loads: left there, its ``tests`` package would shadow this one in
    the processes that later tests spawn."""
    import importlib.util
    import sys
    from pathlib import Path
    bench = str(Path(__file__).resolve().parent.parent / "gpubench")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "reference.vgrnn", Path(bench) / "reference" / "vgrnn.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod


def _ref_window(seed=11):
    """T symmetric snapshots of weights 1-4 on N = 200 nodes."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(REF_T):
        a = np.triu((rng.random((REF_N, REF_N)) < 0.03)
                    * rng.integers(1, 5, (REF_N, REF_N)), 1).astype(float)
        mats.append(sp.csr_matrix(a + a.T))
    loader = TDataLoader([f"u{i}" for i in range(REF_N)], REF_T)
    return mats, (loader.graphs_from_scipy([TD._vgrnn_norm(m) for m in mats],
                                           adj_backend="segment"),
                  loader.graphs_from_scipy(mats, adj_backend="segment"))


def _ref_compare(monkeypatch, round_z=None):
    """The port against the reference on seeded weights and noise: at each
    snapshot enc_mean and z, the VAE loss of two batches that carry h,
    every leaf's gradient summed over both, and every leaf after one Adam
    step.  ``round_z`` rounds z before the port's Gram (its gradient passed
    straight through).  Returns the names of the comparisons that fail."""
    ref = _reference_vgrnn()
    monkeypatch.setattr(TL, "GRAM_CHUNK_ELEMS", REF_ROWS * REF_N)
    monkeypatch.setattr(ref, "CHUNK_ELEMS", REF_ROWS * REF_N)
    assert len(TL._row_chunks(REF_N)) == 5
    if round_z is not None:
        orig = TL.softplus_gram_sum
        monkeypatch.setattr(TL, "softplus_gram_sum", lambda z: orig(
            z + (z.to(round_z).float() - z).detach()))
    from reference.nn import init_params
    mats, (conv, targets) = _ref_window()
    cfg = {"hid_dim": REF_HID, "embed_dim": REF_EMB, "conv_type": "GCN",
           "bias": True, "eps": EPS}
    params0 = init_params(ref.param_spec(cfg, REF_N), 5, "cpu")
    prep = ref.prepare(mats, cfg, "cpu")
    gen = torch.Generator().manual_seed(6)
    noise = [[torch.randn(REF_N, REF_EMB, generator=gen)
              for _ in range(REF_T)] for _ in range(2)]
    model = TV.VGRNN(REF_N, REF_HID, REF_EMB)
    model.load_state_dict(params0)
    opt = TE.make_optimizer(list(model.parameters()), REF_LR, REF_WD)
    data = {"xs": None, "vgrnn_adjs": conv, "adjs": targets}
    loss_fn = TD._vae_loss_fn_stateful(
        lambda m, d, g, hx: TD._vgrnn_forward(m, d, hx=hx, noise=next(it)),
        EPS)
    params = {k: v.clone().requires_grad_() for k, v in params0.items()}
    ref_opt = torch.optim.Adam(list(params.values()), lr=REF_LR,
                               weight_decay=REF_WD, eps=1e-8)
    failed = []

    def check(name, got, want, rtol, atol):
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            failed.append(name)

    it = iter(noise)
    h = TD._vgrnn_state_init(model, data)
    ref_h = None
    for b in range(2):
        with torch.no_grad():
            em, _, (_, _, _, _, z) = TD._vgrnn_forward(
                model, data, hx=h, noise=noise[b])
            outs, _ = ref.run(params, prep, cfg, noise[b], ref_h)
        for t in range(REF_T):
            scale = outs[t][0].abs().max()
            check(f"enc_mean {b}.{t}", em[t], outs[t][0], REF_FWD[0],
                  REF_FWD[1] * scale)
            check(f"z {b}.{t}", z[t], outs[t][4], REF_FWD[0],
                  REF_FWD[1] * outs[t][4].abs().max())
        loss, h = loss_fn(model, data, None, None, None, h)
        loss.backward()
        h = h.detach()
        outs, ref_h = ref.run(params, prep, cfg, noise[b], ref_h)
        ref_loss = ref.vae_loss(outs, prep, cfg)
        ref_loss.backward()
        ref_h = ref_h.detach()
        check(f"loss {b}", loss.detach(), ref_loss.detach(), REF_LOSS, 0)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(params)
    for k, p in params.items():
        check(f"grad {k}", named[k].grad, p.grad, REF_GRAD[0],
              REF_GRAD[1] * p.grad.abs().max())
    opt.step()
    ref_opt.step()
    for k, p in params.items():
        check(f"step {k}", named[k].detach(), p.detach(), 0, REF_STEP)
    return failed


def test_port_equals_the_benchmark_reference(monkeypatch):
    """VGRNN through ``TD._vae_loss_fn_stateful``, the U-own loss, against
    the benchmark's plain reference, in 5 Gram chunks on both sides: every
    comparison within its tolerance (the constants' comments)."""
    assert _ref_compare(monkeypatch) == []


def test_a_bf16_gram_fails_the_reference(monkeypatch):
    """z rounded to bf16 before the Gram (the configuration states
    float32) fails the comparison: the loss and the leaves' gradients move
    by far more than their tolerances."""
    failed = _ref_compare(monkeypatch, round_z=torch.bfloat16)
    assert any(f.startswith("loss") for f in failed), failed
    assert any(f.startswith("grad") for f in failed), failed


def test_noise_draws_equal_the_inline_draw():
    """``_noise`` draws what the forward drew inline before it had a
    function of its own: ``torch.randn`` of [N, embed] from the generator,
    in the weight's dtype and device, bit for bit; and the forward draws
    one a snapshot, in order."""
    like = torch.zeros(3, dtype=torch.float32)
    g1, g2 = (torch.Generator().manual_seed(13) for _ in range(2))
    for n, d in ((N, EMB), (7, 3)):
        want = torch.randn(n, d, generator=g1, device=like.device,
                           dtype=like.dtype)
        assert torch.equal(TV._noise(n, d, g2, like), want)
    tg, _, _, _ = _window()
    model = TV.VGRNN(N, HID, EMB, generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(14)
    drawn = [torch.randn(N, EMB, generator=g) for _ in range(T)]
    with torch.no_grad():
        got = model(None, tg, generator=torch.Generator().manual_seed(14))
        want = model(None, tg, noise=drawn)
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_vae_loss_spans_and_counters(monkeypatch):
    """While tracing: the loss's forward and backward are ``loss`` spans,
    each holding one ``gram`` span a snapshot; the counters read the
    pairs, chunks and nonzeros of the calls; off, the loss is
    bit-equal and keeps no span."""
    from ctgcn_torch.training import profiling
    monkeypatch.setattr(TL, "GRAM_CHUNK_ELEMS", 10 * N)
    _, targets, _, _ = _window()
    inputs = _loss_inputs(7)

    def run():
        tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
        loss = TL.vae_loss(*tin, targets, eps=EPS)
        loss.backward()
        return loss.detach(), [x.grad for x in tin]

    last = profiling.last_trace()
    before = {k: profiling.counter(k) for k in (
        "vae.gram_pairs_fwd", "vae.gram_pairs_bwd", "vae.gram_chunks",
        "vae.sddmm_nnz")}
    off = run()
    assert profiling.last_trace() is last
    with profiling.tracing("cpu") as trace:
        on = run()
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    spans = trace.spans
    assert [s.name for s in spans] == (["loss"] + ["gram"] * T) * 2
    fwd, bwd = spans[0], spans[T + 1]
    assert all(spans[s.parent] is fwd for s in spans[1:T + 1])
    assert all(spans[s.parent] is bwd for s in spans[T + 2:])
    assert bwd.start_ns >= fwd.end_ns and bwd.end_ns >= spans[-1].end_ns
    nnz = sum(g.vals.numel() for g in targets)
    chunks = -(-N // 10)
    assert trace.counters == {
        "vae.gram_pairs_fwd": T * N * N, "vae.gram_pairs_bwd": T * N * N,
        "vae.gram_chunks": 2 * T * chunks, "vae.sddmm_nnz": nnz}
    # off, the counters count too
    assert profiling.counter("vae.gram_pairs_fwd") == (
        before["vae.gram_pairs_fwd"] + 2 * T * N * N)
