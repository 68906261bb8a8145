# coding: utf-8
"""The zoo over several time parts (config ``n_devices``) on gloo ranks on
the CPU, against ``ctgcn_tpu``.

One spawn of 2 ranks of ``tests/_torch_dist_ranks.py``
(``tests/test_torch_dist.py``'s ``_start`` / ``_finish``) on a generated
dataset (N = 60, four snapshots, T = 4, preprocessed by the port's CLI),
each zoo entry of ``configs/uci.json`` at test width under U-neg:

  * each of the 12 zoo methods' step through the driver's layout (time
    sharding for the per-snapshot methods and GCRN; EvolveGCN and VGRNN,
    sequential in time, on one part, rank 1 holding none) against the
    JAX single-device step with the same parameters (``interop``) and
    batch, the JAX sampler's draws, and the JAX forward's own draws given
    where it draws without a key (PGNN's anchor sets, VGRNN's noise;
    dropout 0; TgSAGE samples every neighbour): the loss (1e-5), every
    parameter's gradient, assembled (1e-4 of the model's largest
    gradient, at least 1: GIN's BatchNorms), and the parameters after one
    Adam step (1e-6, where the JAX gradient lies beyond that gradient
    tolerance: elsewhere Adam's first step of lr goes either way on
    rounding);
  * under each config as written (dropout 0.5, TgSAGE's samples, PGNN's
    anchors) the 2-part forward with a seeded generator against the
    port's single-device forward with the same seed: the outputs (1e-6)
    and the generator's next draws (equal), so a part draws what one
    device draws;
  * the CLI with ``n_devices: 2`` for GCN (per snapshot) and GCRN (the
    time RNN after the gather), configs as written, against the port's
    single-device run: CSVs within 1e-5, the model file's keys in order
    and its values within 1e-5.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctgcn_torch import main as cli
from ctgcn_torch.training import driver as TD
from ctgcn_torch.training.engine import read_model_file
from ctgcn_tpu import losses as JL
from ctgcn_tpu.training import driver as JD
from ctgcn_tpu.training.engine import make_optimizer as j_make_optimizer
from tests.test_torch_ctgcn import Q, S, _jax_draws_t
from tests.test_torch_dist import ROOT, _csvs, _finish, _start, _state
from tests.test_torch_pgnn import _jax_window_anchor_sets
from tests.test_torch_vgrnn import _noise

N, T, HID, EMB = 60, 4, 12, 6
ZOO = ("GCN", "TgGCN", "GIN", "TgGIN", "GAT", "TgGAT", "SAGE", "TgSAGE",
       "GCRN", "EvolveGCN", "VGRNN", "PGNN")
#: the methods whose forward draws under its config (dropout, samples,
#: anchors); EvolveGCN and VGRNN, whose slopes and noise one part draws,
#: run on one part
DRAWING = ("GCN", "TgGCN", "GIN", "TgGIN", "GAT", "TgGAT", "SAGE", "TgSAGE",
           "GCRN", "PGNN")
SEED = 3
LR, WD = 1e-3, 5e-4


@pytest.fixture(scope="module")
def zoo_data(tmp_path_factory):
    """The dataset, preprocessed, and each zoo entry of configs/uci.json
    narrowed to it (one window of T = 4, U-neg on the CTGCN-C walks)."""
    base = tmp_path_factory.mktemp("zoo_dist")
    rng = np.random.default_rng(9)
    names = [f"v{i}" for i in range(N)]
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    (base / "1.format").mkdir()
    for t in range(T):
        src = rng.integers(0, N, 120)
        dst = rng.integers(0, N, 120)
        (base / "1.format" / f"2011-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"v{a}\tv{b}\t{rng.integers(1, 5)}\n"
                for a, b in zip(src, dst) if a != b))
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
    emb = {m: dict(uci["embedding"][m], base_path=str(base), hid_dim=HID,
                   embed_dim=EMB, batch_size=25, neg_num=S, Q=Q, epoch=2,
                   duration=T, start_idx=0, end_idx=-1, record_time=False,
                   learning_type="U-neg",
                   walk_pair_folder="CTGCN/ctgcn_walk_pairs",
                   node_freq_folder="CTGCN/ctgcn_node_freq",
                   embed_folder=f"2.embedding/{m}",
                   model_file=m.lower())
           for m in ZOO}
    if "feature_dim" in emb["PGNN"]:
        emb["PGNN"]["feature_dim"] = 8
    return base, emb


def _parity_config(emb, method):
    """The config of the JAX comparison: no dropout, and TgSAGE samples
    every neighbour."""
    conf = dict(emb[method], dropout=0.0)
    if method == "TgSAGE":
        conf["num_sample"] = 1000
    return conf


def _jax_case(emb, method, b_idx, b_mask):
    """The ranks' inputs of ``method``'s step and a function that computes
    the JAX single-device step."""
    conf = _parity_config(emb, method)
    jargs = dict(conf)
    jl = JD.get_data_loader(jargs)
    np.random.seed(8)
    in_j, jadjs, jxs, _ = JD.get_input_data(method, 0, T, jl, jargs)
    jargs["input_dim"] = in_j
    jmodel = JD.get_gnn_model(method, T, jargs, jax.random.key(5))
    base = emb[method]["base_path"]
    walk_j = jl.get_walk_data(*(f"{base}/{conf[k]}" for k in (
        "walk_pair_folder", "node_freq_folder")), 0, T)
    jdata = {"adjs": jadjs, "xs": jxs,
             "neighbor_data": jargs.pop("_neighbor_data", None),
             "vgrnn_adjs": jargs.pop("_vgrnn_norm_adjs", None),
             "pgnn_dists": jargs.pop("_pgnn_dists", None)}
    key = jax.random.key(7)
    draws = [_jax_draws_t(t_key, walk_j.degrees[t][jnp.asarray(b_idx)],
                          walk_j.neg_logits[t])
             for t, t_key in enumerate(jax.random.split(key, T))]
    case = {"config": dict(conf, n_devices=2), "state": _state(jmodel),
        "b_idx": b_idx, "b_mask": b_mask, "Q": Q, "lr": LR, "wd": WD,
        "j": np.stack([np.asarray(d[0]) for d in draws]).astype(np.int64),
        "neg": np.stack([np.asarray(d[1]) for d in draws]).astype(np.int64)}
    if method == "PGNN":
        case["anchors"] = [[a.numpy() for a in sets]
                           for sets in _jax_window_anchor_sets(N, T)]
    if method == "VGRNN":
        case["noise"] = [z.numpy() for z in _noise(jax.random.key(0), N, T,
                                                   EMB)]
    jfwd = JD.make_forward(method)

    def loss(m, d, w):
        res = jfwd(m, d, None)
        return JL.negative_sampling_loss(
            res[0] if method == "VGRNN" else res, jnp.asarray(b_idx),
            jnp.asarray(b_mask), w, key, neg_num=S, Q=Q)

    def reference():
        val, grads = jax.jit(jax.value_and_grad(loss))(jmodel, jdata,
                                                       walk_j)
        opt = j_make_optimizer(LR, WD)
        upd, _ = opt.update(grads, opt.init(jmodel), jmodel)
        return {"loss": float(val), "grads": _state(grads),
                "params": _state(optax.apply_updates(jmodel, upd))}

    return case, reference


def _single_draws(conf, method, state):
    """The port's single-device forward of ``conf`` with a generator seeded
    ``SEED``, and the generator's next draws."""
    args = dict(conf)
    loader = TD.get_data_loader(args)
    trainer = TD.build_trainer(method, args, loader, 0, T,
                               torch.device("cpu"),
                               torch.Generator().manual_seed(0),
                               rng=np.random.RandomState(8))
    trainer.model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in state.items()})
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        res = TD.make_forward(method)(trainer.model, trainer.data, gen)
    return (res[0] if method == "VGRNN" else res).numpy(), \
        torch.rand(8, generator=gen).numpy()


def _cli_config(base, emb, method, tag, **change):
    path = base / f"{tag}.json"
    path.write_text(json.dumps({"embedding": {method: dict(
        emb[method], embed_folder=f"2.embedding/{tag}", model_file=tag,
        **change)}}))
    return str(path)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, zoo_data):
    base, emb = zoo_data
    rng = np.random.default_rng(6)
    b_idx = rng.permutation(N)[:40].astype(np.int32)
    b_mask = np.ones(40, bool)
    b_mask[-3:] = False
    cases, refs = {}, {}
    for method in ZOO:
        cases[method], refs[method] = _jax_case(emb, method, b_idx, b_mask)
    draws = {m: {"config": dict(emb[m], n_devices=2),
                 "state": cases[m]["state"]} for m in DRAWING}
    cli_methods = {"gcn2": "GCN", "gcrn2": "GCRN"}
    inputs = {"zoo_step": {"cases": cases, "draws": draws, "seed": SEED},
              "cli": {"methods": cli_methods, "configs": {
                  tag: _cli_config(base, emb, m, tag, n_devices=2)
                  for tag, m in cli_methods.items()}}}
    jobs = ("zoo_step", "cli")
    workdir = tmp_path_factory.mktemp("zoo2")
    started = _start(2, workdir, jobs, inputs)
    refs = {m: reference() for m, reference in refs.items()}
    for m in DRAWING:
        refs[m]["drawn"], refs[m]["next"] = _single_draws(
            emb[m], m, cases[m]["state"])
    single = {tag: cli.main([
        f"--config={_cli_config(base, emb, m, tag + '-one')}",
        "--task=embedding", f"--method={m}", "--device=cpu"])
        for tag, m in cli_methods.items()}
    return _finish(started, 2, workdir, jobs), refs, single


@pytest.mark.parametrize("method", ZOO)
def test_zoo_time_sharded_step_equals_jax(two_ranks, method):
    out, refs, _ = two_ranks
    got, ref = out["zoo_step"][method], refs[method]
    sequential = method in ("EvolveGCN", "VGRNN")
    assert (got["kind"], got["parts"]) == (
        (None, 1) if sequential else ("time", 2))
    if method == "GCRN":       # rank 0 holds GCNs 0-1 of the four
        assert not any(k.startswith(("gcns.2", "gcns.3"))
                       for k in got["own_keys"])
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert list(got["grads"]) == list(got["params"])
    assert set(got["grads"]) == set(ref["grads"])
    scale = max([1.0] + [float(np.abs(v).max())
                         for v in ref["grads"].values()])
    for k, v in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=f"grad {k}")
        # Adam's first step moves every weight by about lr, in the
        # direction of its gradient's sign: where the JAX gradient lies
        # within the gradient tolerance of 0 (the pre-BatchNorm biases of
        # GIN, whose gradient is 0 but for rounding) the sign is noise
        sure = np.abs(v) > 1e-4 * scale
        np.testing.assert_allclose(got["params"][k][sure],
                                   ref["params"][k][sure], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_array_less(
            np.abs(got["params"][k] - ref["params"][k]), 2 * LR + 1e-6)


@pytest.mark.parametrize("method", DRAWING)
def test_parts_draw_what_one_device_draws(two_ranks, method):
    out, refs, _ = two_ranks
    got, ref = out["zoo_step"][method], refs[method]
    np.testing.assert_allclose(got["drawn"], ref["drawn"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got["next"], ref["next"])


@pytest.mark.parametrize("tag, method", [("gcn2", "GCN"),
                                         ("gcrn2", "GCRN")])
def test_cli_on_two_ranks_equals_one_device(two_ranks, zoo_data, tag,
                                            method):
    out, _, single = two_ranks
    base, emb = zoo_data
    res = out["cli"][tag]
    assert [r["parts"] for r in res] == [2]
    np.testing.assert_allclose(res[0]["losses"], single[tag][0]["losses"],
                               rtol=1e-5)
    got, ref = (_csvs(base / "2.embedding" / t) for t in (tag, tag + "-one"))
    assert list(got) == list(ref) and len(ref) == T
    for f in ref:
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    model_dir = base / emb[method]["model_folder"]
    got = read_model_file(model_dir / tag)
    ref = read_model_file(model_dir / (tag + "-one"))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
