# coding: utf-8
"""The port's multi-device paths (``ctgcn_torch/parallel/``) on gloo ranks
on the CPU, against ``ctgcn_tpu``.

Two spawns of ``tests/_torch_dist_ranks.py`` (a ``file://`` store under
``tmp_path``, a 60 s collective timeout, a 120 s join limit, one thread a
rank), inputs made here from numpy seeds:

  * 4 ranks: ``sharded_spmm``, ``sharded_spmm_halo``,
    ``sharded_gcn_layer`` (its weight's gradient),
    ``partitioned_core_diffusion`` (GRU, LSTM), ``halo_gcn_forward`` and
    ``halo_core_forward`` (CGCN-S, CTGCN-C), forward and gradients, against
    the JAX ``shard_map`` versions on ``make_mesh(4, axis_name="graph")``
    over the 8 virtual CPU devices: within 1e-5 relative (an absolute
    floor of 1e-5 of the largest reference value, for entries near 0);
  * 2 ranks: the time-sharded step of CTGCN-C (U-neg, the JAX sampler's
    draws) and CTGCN-S (U-own) at T = 4 against the JAX single-device step
    with the same parameters (``interop``) and batch: the loss (1e-5), every
    parameter's gradient, assembled (1e-4, f32 gradients through GRUs),
    and the parameters after one Adam step (1e-6); the gather's gradient
    (each part's slice, once); and the CLI, CTGCN-C U-neg with ``n_devices:
    2`` and with ``graph_partition: true``, against the port's
    single-device run: CSVs within 1e-5, the model file's keys in order and
    its values within 1e-5;
  * one process, one part: ``partitioned_core_diffusion`` over the part's
    kept slots (3 of K = 5) against the same layer over all K slots
    masked, forward and gradients within rtol 1e-6 (the (L·L) prefix
    GEMM sums over fewer slots).
"""
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
import torch.multiprocessing as mp
from flax import serialization

from ctgcn_torch import main as cli
from ctgcn_torch.interop import params_from_numpy
from ctgcn_torch.training.engine import read_model_file
from ctgcn_tpu import losses as JL
from ctgcn_tpu.nn.core_models import CGCN as JCGCN
from ctgcn_tpu.nn.core_models import CTGCN as JCTGCN
from ctgcn_tpu.nn.core_models import CoreDiffusion as JCoreDiffusion
from ctgcn_tpu.nn.gcn import GCN as JGCN
from ctgcn_tpu.ops.pyramid import build_core_pyramid, stack_pyramids
from ctgcn_tpu.parallel import core_partition as JC
from ctgcn_tpu.parallel import graph_partition as JG
from ctgcn_tpu.parallel.mesh import make_mesh
from ctgcn_tpu.training.engine import make_optimizer as j_make_optimizer

from tests import _torch_dist_ranks

ROOT = Path(__file__).resolve().parent.parent
JOIN_SECONDS = 120
RTOL = 1e-5


def _start(world, workdir, jobs, inputs):
    """Write each job's inputs and start the ranks; ``_finish`` joins
    them (the test computes its JAX side while they run)."""
    for job in jobs:
        with open(workdir / f"{job}_in.pkl", "wb") as fp:
            pickle.dump(inputs[job], fp)
    ctx = mp.start_processes(_torch_dist_ranks.main,
                             args=(world, str(workdir), jobs), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, time.time() + JOIN_SECONDS


def _finish(started, world, workdir, jobs):
    """Join the ranks (killing them past the join limit) and read rank 0's
    outputs."""
    ctx, deadline = started
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {JOIN_SECONDS} s")
    out = {}
    for job in jobs:
        with open(workdir / f"{job}_out.pkl", "rb") as fp:
            out[job] = pickle.load(fp)
    return out


def _close(got, ref, rtol=RTOL, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=name)


def _jax_out_grad(fn, loss, *args, argnums=0):
    """fn(*args) and the gradient of loss(fn(*args)), from one compile."""
    def f(*a):
        out = fn(*a)
        return loss(out), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=argnums, has_aux=True))(*args)
    return out, grads


def _tanh_sum(y):
    return jnp.sum(jnp.tanh(y))


def _state(tree):
    return {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, serialization.to_state_dict(tree))).items()}


def _graph(rng, n, density=0.12, hub=3):
    a = (rng.random((n, n)) < density) * rng.uniform(0.5, 2.0, (n, n))
    a[hub, rng.random(n) < 0.7] = 1.0
    a = np.triu(a, 1)
    return sp.coo_matrix((a + a.T).astype(np.float32))


def _core_mats(a, levels=(3, 3, 2, 1)):
    csr = sp.csr_matrix(a)
    deg = np.asarray((csr != 0).sum(1)).ravel()
    return [sp.csr_matrix(csr.multiply(np.outer(deg >= k, deg >= k)))
            for k in levels]


# ---------------------------------------------------------------------------
# 4 ranks: the halo modules against the JAX shard_map versions
# ---------------------------------------------------------------------------

HALO_N, HALO_T = 50, 2


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    """(rank 0's outputs, the JAX references)."""
    rng = np.random.default_rng(0)
    mesh = make_mesh(4, axis_name="graph")
    n = HALO_N
    a = _graph(rng, n)
    rpp = JG.partition_graph(a, 4).rows_per_part
    x = rng.standard_normal((4 * rpp, 8)).astype(np.float32)
    inp, ref = {"A": a, "x": x}, {}

    w = (0.1 * rng.standard_normal((8, 5))).astype(np.float32)
    mats = _core_mats(_graph(rng, n, density=0.2))
    xc = rng.standard_normal((n, 8)).astype(np.float32)
    layers = {rnn_type: JCoreDiffusion.init(jax.random.key(1), 8, 12,
                                            rnn_type=rnn_type)
              for rnn_type in ("GRU", "LSTM")}
    gmats = [_graph(rng, n, density=0.1, hub=7) for _ in range(HALO_T)]
    gcn = JGCN.init(jax.random.key(2), n, 10, 6, dropout=0.0)
    core_mats_t = [_core_mats(_graph(rng, n, density=0.2))
                   for _ in range(HALO_T)]
    models = {
        "CGCN-S": (JCGCN.init(jax.random.key(3), n, 10, 8, trans_num=2,
                              diffusion_num=2, model_type="S",
                              trans_activate_type="N"),
                   dict(trans_num=2, diffusion_num=2, model_type="S",
                        trans_activate_type="N")),
        "CTGCN-C": (JCTGCN.init(jax.random.key(4), n, 10, 8, trans_num=1,
                                diffusion_num=2, duration=HALO_T),
                    dict(trans_num=1, diffusion_num=2, duration=HALO_T)),
    }
    inp.update(w=w, core_mats=mats, xc=xc,
               layers={k: _state(v) for k, v in layers.items()},
               gcn={"dims": (n, 10, 6), "state": _state(gcn),
                    "mats": gmats, "n": n},
               core_models={name: {"dims": (n, 10, 8), "kw": kw,
                                   "state": _state(model),
                                   "mats": core_mats_t, "n": n}
                            for name, (model, kw) in models.items()})
    workdir = tmp_path_factory.mktemp("halo")
    started = _start(4, workdir, ("halo",), {"halo": inp})

    pg = JG.place_partitioned(mesh, JG.partition_graph(a, 4))
    hpg = JG.partition_graph_halo(a, 4)
    for name, fn in (("spmm", lambda xx: JG.sharded_spmm(mesh, pg, xx)),
                     ("spmm_halo",
                      lambda xx: JG.sharded_spmm_halo(mesh, hpg, xx))):
        out, gx = _jax_out_grad(fn, lambda y: _tanh_sum(y[:n]),
                                jnp.asarray(x))
        ref[name], ref[name + "_dx"] = np.asarray(out)[:n], \
            np.asarray(gx)[:n]
    ref["gcn_layer_dw"] = np.asarray(_jax_out_grad(
        lambda ww: JG.sharded_gcn_layer(mesh, pg, jnp.asarray(x), ww),
        _tanh_sum, jnp.asarray(w))[1])

    ppyr = JC.partition_pyramid_halo(mats, n, 4)
    xpad = jnp.pad(jnp.asarray(xc), ((0, ppyr.n_rows - n), (0, 0)))
    for rnn_type, layer in layers.items():
        out, (gl, gx) = _jax_out_grad(
            lambda l, xx: JC.partitioned_core_diffusion(mesh, l, xx,
                                                        ppyr)[:n],
            _tanh_sum, layer, xpad, argnums=(0, 1))
        ref[f"cdn_{rnn_type}"] = np.asarray(out)
        ref[f"cdn_{rnn_type}_dx"] = np.asarray(gx)[:n]
        ref[f"cdn_{rnn_type}_grads"] = _state(gl)

    hpgs = tuple(JG.partition_graph_halo(m, 4) for m in gmats)
    out, grads = _jax_out_grad(
        lambda m: JG.halo_gcn_forward(mesh, m, None, hpgs, n), _tanh_sum,
        gcn)
    ref["gcn"], ref["gcn_grads"] = np.asarray(out), _state(grads)

    k = max(len(m) for m in core_mats_t)
    ppyrs = tuple(JC.partition_pyramid_halo(m, n, 4, num_slots=k)
                  for m in core_mats_t)

    def core_loss(res):
        if isinstance(res, tuple):
            return _tanh_sum(res[0]) + 0.5 * jnp.sum(jnp.square(res[1]))
        return _tanh_sum(res)

    for name, (model, _) in models.items():
        res, grads = _jax_out_grad(
            lambda m: JC.halo_core_forward(mesh, m, None, ppyrs, n),
            core_loss, model)
        if isinstance(res, tuple):
            ref[name], ref[name + "_trans"] = map(np.asarray, res)
        else:
            ref[name] = np.asarray(res)
        ref[name + "_grads"] = _state(grads)
    return _finish(started, 4, workdir, ("halo",))["halo"], ref


@pytest.mark.parametrize("name", ["spmm", "spmm_halo"])
def test_row_sharded_spmm_equals_jax(halo, name):
    got, ref = halo
    _close(got[name], ref[name], name=name)
    _close(got[name + "_dx"], ref[name + "_dx"], name=name + " dx")


def test_sharded_gcn_layer_weight_gradient_equals_jax(halo):
    """The replicated weight's gradient, summed over the parts."""
    got, ref = halo
    _close(got["gcn_layer_dw"], ref["gcn_layer_dw"], name="dW")


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_partitioned_core_diffusion_equals_jax(halo, rnn_type):
    got, ref = halo
    key = f"cdn_{rnn_type}"
    _close(got[key], ref[key], name=key)
    _close(got[key + "_dx"], ref[key + "_dx"], name=key + " dx")
    assert set(got[key + "_grads"]) == set(ref[key + "_grads"])
    for k, v in ref[key + "_grads"].items():
        _close(got[key + "_grads"][k], v, name=f"{key} {k}")


def test_halo_gcn_forward_equals_jax(halo):
    got, ref = halo
    assert got["gcn"].shape == (HALO_T, HALO_N, 6)
    _close(got["gcn"], ref["gcn"], name="gcn")
    assert set(got["gcn_grads"]) == set(ref["gcn_grads"])
    for k, v in ref["gcn_grads"].items():
        _close(got["gcn_grads"][k], v, name=f"gcn {k}")


@pytest.mark.parametrize("name", ["CGCN-S", "CTGCN-C"])
def test_halo_core_forward_equals_jax(halo, name):
    got, ref = halo
    _close(got[name], ref[name], name=name)
    if name + "_trans" in ref:
        _close(got[name + "_trans"], ref[name + "_trans"], name="trans")
    assert set(got[name + "_grads"]) == set(ref[name + "_grads"])
    for k, v in ref[name + "_grads"].items():
        _close(got[name + "_grads"][k], v, name=f"{name} {k}")


def _masked_core_diffusion(layer, x_shard, part, parts):
    """``partitioned_core_diffusion`` over all K slots, the empty ones
    masked (the run without the part's kept count)."""
    from ctgcn_torch.ops.rnn import core_rnn_sum
    from ctgcn_torch.parallel.graph_partition import sharded_spmm_halo
    K, rpp = part.num_slots, part.rows_per_part
    valid = part.valid.float()
    contribs = sharded_spmm_halo(part, x_shard, parts).reshape(K, rpp, -1) \
        * valid[:, None, None]
    lower = torch.tril(torch.ones(K, K))
    acc = ((lower @ lower) @ contribs.reshape(K, -1)).reshape(
        contribs.shape) + x_shard[None]
    return layer.norm(core_rnn_sum(layer.rnn, acc, valid,
                                   layer.cvjp_batch_budget))


@pytest.mark.parametrize("cvjp", ["lean", "K-batched"])
@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_partitioned_core_diffusion_trimmed_equals_masked(rnn_type, cvjp):
    from ctgcn_torch.nn.core_models import CoreDiffusion
    from ctgcn_torch.ops.rnn import CVJP_BATCH_BUDGET
    from ctgcn_torch.parallel.core_partition import (
        partition_pyramid_halo, partitioned_core_diffusion)
    from ctgcn_torch.parallel.dist import Parts
    rng = np.random.default_rng(6)
    mats = _core_mats(_graph(rng, HALO_N, density=0.2),
                      levels=(13, 10, 10, 1))
    part = partition_pyramid_halo(mats, HALO_N, 1, num_slots=5).part(0)
    assert part.kept == 3 and part.num_slots == 5
    layer = CoreDiffusion(8, 12, rnn_type=rnn_type,
                          generator=torch.Generator().manual_seed(6),
                          cvjp_batch_budget=0 if cvjp == "lean"
                          else CVJP_BATCH_BUDGET)
    x0 = torch.from_numpy(rng.standard_normal(
        (part.rows_per_part, 8)).astype(np.float32))
    got = []
    for fn in (_masked_core_diffusion, partitioned_core_diffusion):
        layer.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        out = fn(layer, x, part, Parts(1, 0))
        torch.tanh(out).sum().backward()
        got.append([out.detach(), x.grad] + [p.grad
                                             for p in layer.parameters()])
    for mine, want in zip(got[1], got[0], strict=True):
        _close(mine.numpy(), want.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# 2 ranks: the time-sharded step, the gradient rule and the CLI
# ---------------------------------------------------------------------------

T, N, HID, EMB, S, Q = 4, 60, 12, 8, 4, 10.0


def _walk(rng):
    flats, offs, degs, logits = [], [], [], []
    for _ in range(T):
        a = np.triu(rng.random((N, N)) < 0.08, 1)
        csr = sp.csr_matrix((a | a.T).astype(np.float32))
        flats.append(csr.indices.astype(np.int32))
        offs.append(csr.indptr[:-1].astype(np.int32))
        degs.append(np.diff(csr.indptr).astype(np.int32))
        logits.append(np.log(rng.integers(1, 40, N)).astype(np.float32))
    flat = np.zeros((T, max(len(f) for f in flats)), np.int32)
    for t, f in enumerate(flats):
        flat[t, :len(f)] = f
    return dict(nbr_flat=flat, nbr_offsets=np.stack(offs),
                degrees=np.stack(degs), neg_logits=np.stack(logits))


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


def _time_case(model_type, seed):
    """The inputs of a case for the ranks, and a function that computes
    the JAX single-device step on them."""
    rng = np.random.default_rng(seed)
    mats = [_core_mats(_graph(rng, N, density=0.1), levels=(4, 2, 1))
            for _ in range(T)]
    k = max(len(m) for m in mats)
    jpyr = stack_pyramids([build_core_pyramid(m, N, num_slots=k)
                           for m in mats])
    kw = dict(trans_num=1 if model_type == "C" else 2, diffusion_num=2,
              duration=T, model_type=model_type)
    jmodel = JCTGCN.init(jax.random.key(seed), N, HID, EMB, **kw)
    b_idx = rng.permutation(N)[:40].astype(np.int32)
    b_mask = np.ones(40, bool)
    b_mask[-3:] = False
    walk = _walk(rng)
    walk_j = JL.WalkData(**{kk: jnp.asarray(v) for kk, v in walk.items()})
    key = jax.random.key(seed + 7)
    lr, wd = 1e-3, 5e-4

    def loss(m):
        res = m(None, jpyr)
        if model_type == "S":
            return JL.reconstruction_loss(res[0], res[1], jnp.asarray(b_idx),
                                          jnp.asarray(b_mask))
        return JL.negative_sampling_loss(res, jnp.asarray(b_idx),
                                         jnp.asarray(b_mask), walk_j, key,
                                         neg_num=S, Q=Q)

    def reference():
        val, grads = jax.jit(jax.value_and_grad(loss))(jmodel)
        opt = j_make_optimizer(lr, wd)
        upd, _ = opt.update(grads, opt.init(jmodel), jmodel)
        return {"loss": float(val), "grads": _state(grads),
                "params": _state(optax.apply_updates(jmodel, upd))}

    case = {"mats": mats, "n": N, "dims": (N, HID, EMB), "kw": kw,
            "state": _state(jmodel), "b_idx": b_idx, "b_mask": b_mask,
            "walk": walk, "Q": Q, "lr": lr, "wd": wd}
    if model_type == "C":
        draws = [_jax_draws_t(t_key, walk_j.degrees[t][jnp.asarray(b_idx)],
                              walk_j.neg_logits[t])
                 for t, t_key in enumerate(jax.random.split(key, T))]
        case["j"] = np.stack([np.asarray(d[0]) for d in draws]).astype(
            np.int64)
        case["neg"] = np.stack([np.asarray(d[1]) for d in draws]).astype(
            np.int64)
    return case, reference


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A small preprocessed dataset (4 snapshots, T = 4) and the port's
    single-device CTGCN-C run on it; (base, config of a tag, its
    results)."""
    base = tmp_path_factory.mktemp("dist_cli")
    rng = np.random.default_rng(5)
    names = [f"u{i}" for i in range(120)]
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    (base / "1.format").mkdir()
    for t in range(4):
        src = rng.integers(0, 120, 500)
        dst = rng.integers(0, 120 // (t + 1) + 8, 500) % 120
        (base / "1.format" / f"2010-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"u{a}\tu{b}\t{rng.integers(1, 5)}\n"
                for a, b in zip(src, dst)))
    with open(ROOT / "configs" / "uci.json") as fp:
        uci = json.load(fp)
    pre = dict(uci["preprocessing"]["CTGCN-C"], base_path=str(base),
               walk_time=3)
    (base / "pre.json").write_text(json.dumps(
        {"preprocessing": {"CTGCN-C": pre}}))
    proc = subprocess.run(
        [sys.executable, "-m", "ctgcn_torch.main",
         f"--config={base / 'pre.json'}", "--task=preprocessing",
         "--method=CTGCN-C", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    emb = dict(uci["embedding"]["CTGCN-C"], base_path=str(base), epoch=2,
               duration=4, hid_dim=12, embed_dim=6, batch_size=50,
               neg_num=4, record_time=False)

    def config(tag, **change):
        path = base / f"{tag}.json"
        path.write_text(json.dumps({"embedding": {"CTGCN-C": dict(
            emb, embed_folder=f"2.embedding/{tag}", model_file=tag,
            **change)}}))
        return str(path)

    single = cli.main([f"--config={config('single')}", "--task=embedding",
                       "--method=CTGCN-C", "--device=cpu"])
    return base, config, single


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, cli_data):
    _, config, _ = cli_data
    cases, refs = {}, {}
    for name, (model_type, seed) in {"CTGCN-C": ("C", 11),
                                     "CTGCN-S": ("S", 12)}.items():
        cases[name], refs[name] = _time_case(model_type, seed)
    inputs = {"time": {"cases": cases},
              "cli": {"method": "CTGCN-C", "configs": {
                  "time2": config("time2", n_devices=2),
                  "halo2": config("halo2", n_devices=2,
                                  graph_partition=True)}}}
    workdir = tmp_path_factory.mktemp("two")
    started = _start(2, workdir, ("time", "cli"), inputs)
    refs = {name: reference() for name, reference in refs.items()}
    return _finish(started, 2, workdir, ("time", "cli")), refs


@pytest.mark.parametrize("name", ["CTGCN-C", "CTGCN-S"])
def test_time_sharded_step_equals_jax(two_ranks, name):
    out, refs = two_ranks
    got, ref = out["time"][name], refs[name]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    # rank 0 holds timesteps 0-1 of the stacked containers, nothing more
    assert got["own"] == [0, 2]
    assert not any(k.startswith(("mlps.2", "mlps.3", "cdns.2", "cdns.3"))
                   for k in got["own_keys"])
    assert list(got["grads"]) == list(got["params"])
    assert set(got["grads"]) == set(ref["grads"])
    for k, v in ref["grads"].items():
        _close(got["grads"][k], v, rtol=1e-4, name=f"grad {k}")
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_gather_gradient_is_each_parts_slice_once(two_ranks):
    """Every part computes the whole loss sum(w_i y_i) from the gathered
    y: each part's x gets w over its own rows (not twice that)."""
    out, _ = two_ranks
    np.testing.assert_array_equal(out["time"]["rule_y"],
                                  [[1.0] * 3] * 2 + [[2.0] * 3] * 2)
    np.testing.assert_array_equal(out["time"]["rule_dx"],
                                  np.repeat(np.arange(1.0, 5.0)[:, None], 3,
                                            1))


def _csvs(folder):
    return {p.name: np.loadtxt(p, delimiter="\t", skiprows=1,
                               usecols=range(1, 7))
            for p in sorted(folder.iterdir())}


@pytest.mark.parametrize("tag, backend", [("time2", "blocks"),
                                          ("halo2", "halo")])
def test_cli_on_two_ranks_equals_one_device(two_ranks, cli_data, tag,
                                            backend):
    """``n_devices: 2`` (T = 4: two time parts) and ``graph_partition``
    (two row parts) on 2 gloo ranks export what one device exports."""
    out, _ = two_ranks
    base, _, single = cli_data
    res = out["cli"][tag]
    assert [(r["parts"], r["core_backend"]) for r in res] == [(2, backend)]
    np.testing.assert_allclose(res[0]["losses"], single[0]["losses"],
                               rtol=1e-5)
    got, ref = (_csvs(base / "2.embedding" / t) for t in (tag, "single"))
    assert list(got) == list(ref) and len(ref) == 4
    for f in ref:
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    model_dir = base / "CTGCN" / "model"
    got = read_model_file(model_dir / tag)
    ref = read_model_file(model_dir / "single")
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
