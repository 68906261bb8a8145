# coding: utf-8
"""The slice as a whole against ``ctgcn_tpu`` on a toy window (N = 150,
T = 3, K <= 3, hid 16, embed 8, two CoreDiffusion layers, BSR plans; the
JAX side runs its Pallas kernels in interpret mode).

Parameters go across with ``ctgcn_torch.interop.params_from_numpy``.  The
loss is compared with the JAX sampler's own draws handed to the port's
loss arithmetic; the port's samplers are checked by distribution.
Tolerance: f32 values 1e-5, gradients 1e-4, parameters after Adam 1e-6.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
from flax import serialization

from ctgcn_torch import losses as TL
from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.nn.core_models import CTGCN as TCTGCN
from ctgcn_torch.ops.pyramid import build_core_pyramid as t_build
from ctgcn_torch.ops.pyramid import stack_pyramids as t_stack
from ctgcn_torch.training.engine import make_optimizer
from ctgcn_tpu import losses as JL
from ctgcn_tpu.nn.core_models import CTGCN as JCTGCN
from ctgcn_tpu.ops.pyramid import build_core_pyramid as j_build
from ctgcn_tpu.ops.pyramid import stack_pyramids as j_stack
from ctgcn_tpu.training.engine import make_optimizer as j_make_optimizer

N, T, HID, EMB, S, Q = 150, 3, 16, 8, 5, 20.0


def _window(seed=0):
    """T snapshots of nested k-core matrices (max core first); snapshot 1
    repeats a core, so its delta-skip marks a slot invalid."""
    rng = np.random.default_rng(seed)
    per_snap = []
    for t in range(T):
        dense = (rng.random((N, N)) < 0.05) * rng.integers(1, 4, (N, N))
        a = np.triu(dense, 1)
        a = a + a.T
        deg = (a != 0).sum(1)
        levels = [6, 3, 1] if t != 2 else [4, 1]
        mats = [sp.csr_matrix(a * np.outer(deg >= k, deg >= k))
                for k in levels]
        if t == 1:
            mats.insert(1, mats[0].copy())
        per_snap.append(mats[:3])
    return per_snap


@pytest.fixture(scope="module")
def window():
    per_snap = _window()
    K = max(len(m) for m in per_snap)
    jpyr = j_stack([j_build(m, N, num_slots=K, build_plans=True)
                    for m in per_snap])
    tpyr = t_stack([t_build(m, N, num_slots=K, build_plans=True)
                    for m in per_snap])
    np.testing.assert_array_equal(tpyr.valid.numpy(), np.asarray(jpyr.valid))
    assert not tpyr.valid.all()           # the delta-skip took a slot
    # the port's window keeps each snapshot's own plans, unpadded
    for p in tpyr.plan_fwd + tpyr.plan_t:
        assert p.num_blocks == int(p.row_ptr[-1])
    return jpyr, tpyr


@pytest.fixture(scope="module")
def models():
    jmodel = JCTGCN.init(jax.random.key(0), N, HID, EMB, trans_num=1,
                         diffusion_num=2, duration=T)
    tree = jax.tree.map(np.asarray, serialization.to_state_dict(jmodel))
    return jmodel, tree


@pytest.fixture(scope="module")
def jax_forward(window, models):
    jpyr, _ = window
    jmodel, _ = models
    return np.asarray(jax.jit(lambda m, p: m(None, p))(jmodel, jpyr))


def _tmodel(tree, **kw):
    model = TCTGCN(N, HID, EMB, trans_num=1, diffusion_num=2, duration=T,
                   **kw)
    state = params_from_numpy(tree)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def _grads_as_state(tree_grads):
    return params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(tree_grads)))


@pytest.fixture(scope="module")
def walk():
    return _walk_tables()


def _walk_tables():
    """Random symmetric partner lists (CSR) and unigram logits."""
    rng = np.random.default_rng(1)
    flats, offs, degs, logits = [], [], [], []
    for _ in range(T):
        a = rng.random((N, N)) < 0.04
        a = np.triu(a, 1)
        csr = sp.csr_matrix((a | a.T).astype(np.float32))
        flats.append(csr.indices.astype(np.int32))
        offs.append(csr.indptr[:-1].astype(np.int32))
        degs.append(np.diff(csr.indptr).astype(np.int32))
        counts = rng.integers(0, 40, N).astype(np.float64)
        with np.errstate(divide="ignore"):
            logits.append(np.log(counts).astype(np.float32))
    width = max(len(f) for f in flats)
    flat = np.zeros((T, width), np.int32)
    for t, f in enumerate(flats):
        flat[t, :len(f)] = f
    arrays = dict(nbr_flat=flat, nbr_offsets=np.stack(offs),
                  degrees=np.stack(degs), neg_logits=np.stack(logits))
    return (JL.WalkData(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TL.WalkData(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _batch():
    rng = np.random.default_rng(2)
    b_idx = rng.permutation(N)[:64].astype(np.int32)
    b_mask = np.ones(64, bool)
    b_mask[-4:] = False
    return b_idx, b_mask


@jax.jit
def _jax_draws_t(t_key, deg, neg_logits):
    """One timestamp's draws of ``ctgcn_tpu.losses.negative_sampling_loss``
    from its key (the same split and draw sequence, replayed)."""
    kpos, kneg = jax.random.split(t_key)
    chosen = jnp.full((S, deg.shape[0]), -1, jnp.int32)
    for s, kk in enumerate(jax.random.split(kpos, S)):
        hi = jnp.maximum(deg - S + s, 0)
        r = jax.random.randint(kk, deg.shape, 0, hi + 1)
        dup = jnp.any(chosen == r[None, :], axis=0)
        chosen = chosen.at[s].set(jnp.where(dup, hi, r))
    j = jnp.where(deg[:, None] <= S, jnp.arange(S)[None, :], chosen.T)
    return j, jax.random.categorical(kneg, neg_logits, shape=(S,))


def _jax_draws(key, walk_j, b_idx):
    """The positive slots [T, B, S] and negatives [T, S] the JAX loss
    draws from ``key``."""
    js, negs = zip(*(
        _jax_draws_t(t_key, walk_j.degrees[t][jnp.asarray(b_idx)],
                     walk_j.neg_logits[t])
        for t, t_key in enumerate(jax.random.split(key, T))))
    return (torch.from_numpy(np.stack(js)).long(),
            torch.from_numpy(np.stack(negs)).long())


@pytest.mark.parametrize("remat", ["none", "timestep", "layer"])
def test_forward_matches(window, models, jax_forward, remat):
    """The CTGCN-C forward, with and without the memory knobs (which must
    change nothing but the backward's schedule)."""
    _, tpyr = window
    _, tree = models
    kw = {"none": {}, "timestep": {"act_budget": 0},
          "layer": {"layer_remat": True}}[remat]
    model = _tmodel(tree, **kw)
    ref = jax_forward
    got = model(None, tpyr)
    assert got.shape == (T, N, EMB)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def jax_loss(window, models, walk):
    """The JAX loss, its parameter gradients (as a port state_dict) and the
    indices its sampler drew, for one batch."""
    jpyr, _ = window
    jmodel, _ = models
    walk_j, _ = walk
    b_idx, b_mask = _batch()
    key = jax.random.key(7)

    def jloss(m):
        return JL.negative_sampling_loss(
            m(None, jpyr), jnp.asarray(b_idx), jnp.asarray(b_mask), walk_j,
            key, neg_num=S, Q=Q)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jmodel)
    j_idx, neg_idx = _jax_draws(key, walk_j, b_idx)
    return (float(jval), _grads_as_state(jgrads), torch.from_numpy(b_idx),
            torch.from_numpy(b_mask), j_idx, neg_idx)


@pytest.mark.parametrize("remat", ["none", "timestep", "layer"])
def test_loss_and_grads_match(window, models, walk, jax_loss, remat):
    _, tpyr = window
    _, tree = models
    _, walk_t = walk
    jval, ref, b_idx, b_mask, j_idx, neg_idx = jax_loss
    kw = {"none": {}, "timestep": {"act_budget": 0},
          "layer": {"layer_remat": True}}[remat]
    model = _tmodel(tree, **kw)
    loss = TL.uneg_loss(model(None, tpyr), b_idx.long(), b_mask, walk_t,
                        j_idx, neg_idx, Q=Q)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jval, rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_adam_with_weight_decay_matches_optax(models):
    """Two steps from the same gradients: torch Adam(weight_decay) and the
    JAX package's optax chain give the same parameters."""
    jmodel, tree = models
    model = _tmodel(tree)
    lr, wd = 1e-3, 5e-4
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        jmodel) for _ in range(2)]
    opt = j_make_optimizer(lr, wd)
    state = opt.init(jmodel)
    jparams = jmodel
    topt = make_optimizer(list(model.parameters()), lr, wd)
    named = dict(model.named_parameters())

    @jax.jit
    def jstep(g, state, params):
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    for g in grads:
        jparams, state = jstep(g, state, jparams)
        for name, gt in _grads_as_state(g).items():
            named[name].grad = gt
        topt.step()
    ref = params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(jparams)))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_floyd_subsets_are_uniform():
    """A node with 6 partners and S = 3: every one of the C(6, 3) = 20
    subsets comes up equally often, the picks are distinct and in range;
    a node with at most S partners takes all of them in slot order."""
    deg6 = torch.tensor([[6, 2]], dtype=torch.int32)
    walk = TL.WalkData(nbr_flat=torch.zeros(1, 8, dtype=torch.int32),
                       nbr_offsets=torch.tensor([[0, 6]], dtype=torch.int32),
                       degrees=deg6,
                       neg_logits=torch.zeros(1, 2))
    gen = torch.Generator().manual_seed(0)
    b = torch.tensor([0] * 4000 + [1])
    counts = dict.fromkeys(itertools.combinations(range(6), 3), 0)
    for _ in range(5):
        j, _ = TL.sample_uneg(walk, b, 3, gen)
        picks = j[0, :-1].sort(dim=-1).values
        assert (picks[:, 1:] > picks[:, :-1]).all()
        assert picks.min() >= 0 and picks.max() < 6
        for row in picks.tolist():
            counts[tuple(row)] += 1
        assert j[0, -1].tolist() == [0, 1, 2]
    freq = np.array(list(counts.values())) / 20000
    # 20000 draws over 20 cells: sd of a cell's share ~0.0015
    np.testing.assert_allclose(freq, 1 / 20, atol=0.006)


def test_negatives_follow_the_unigram_table():
    counts = np.array([0, 1, 2, 7, 10], np.float64)
    with np.errstate(divide="ignore"):
        logits = torch.from_numpy(np.log(counts).astype(np.float32))[None]
    reps = 2000     # timestamps, each drawing S = 20 negatives
    walk = TL.WalkData(nbr_flat=torch.zeros(reps, 1, dtype=torch.int32),
                       nbr_offsets=torch.zeros(reps, 5, dtype=torch.int32),
                       degrees=torch.zeros(reps, 5, dtype=torch.int32),
                       neg_logits=logits.expand(reps, 5))
    gen = torch.Generator().manual_seed(1)
    draws = TL.sample_uneg(walk, torch.arange(5), 20, gen)[1]
    freq = np.bincount(draws.numpy().ravel(), minlength=5) / draws.numel()
    assert freq[0] == 0
    # 40000 draws: sd of a share <= 0.0025
    np.testing.assert_allclose(freq, counts / counts.sum(), atol=0.01)
