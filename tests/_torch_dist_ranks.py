# coding: utf-8
"""Rank entry of the port's multi-rank tests (``tests/test_torch_dist.py``,
``tests/test_torch_pipeline.py``, ``tests/test_torch_zoo_dist.py``,
``tests/test_torch_supervised_dist.py``): one gloo process of a
``torch.multiprocessing`` spawn (which re-imports this module, so it
imports no JAX).

    main(rank, world, workdir, jobs)

joins the group through ``parallel.dist.init_from_env`` with a ``file://``
store under ``workdir`` and a 60 s timeout, runs each of ``jobs``
(``JOBS[job]`` on the inputs the test wrote to ``<workdir>/<job>_in.pkl``)
and, on rank 0, writes what each returns to ``<workdir>/<job>_out.pkl``.
"""
import datetime
import os
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ctgcn_torch import losses as TL
from ctgcn_torch.nn.core_models import CGCN, CTGCN, CoreDiffusion
from ctgcn_torch.nn.gcn import GCN, GCRN
from ctgcn_torch.ops.pyramid import build_core_pyramid, stack_pyramids
from ctgcn_torch.parallel.core_partition import (
    halo_core_forward, partition_pyramid_halo, partitioned_core_diffusion)
from ctgcn_torch.parallel.dist import (all_reduce_grads, gather_own,
                                       init_from_env, make_parts)
from ctgcn_torch.parallel.graph_partition import (
    halo_gcn_forward, partition_graph, partition_graph_halo,
    sharded_gcn_layer, sharded_spmm, sharded_spmm_halo)
from ctgcn_torch.parallel.mesh import (Sharding, shard_time, time_chunk,
                                       time_sharded_forward)
from ctgcn_torch.parallel.pipeline import (ctgcn_pipelined_forward,
                                           pipelined_rnn_scan)
from ctgcn_torch.ops.rnn import GRUCell, LSTMCell
from ctgcn_torch.training.engine import make_optimizer, save_model_file


def _np(t):
    return t.detach().numpy().copy()


def _gather_rows(t, parts):
    """Every part's t (no gradient), concatenated along dim 0."""
    bufs = [torch.empty_like(t) for _ in range(parts.count)]
    dist.all_gather(bufs, t.contiguous(), group=parts.group)
    return torch.cat(bufs)


def _grads(module):
    return {k: _np(p.grad) for k, p in module.named_parameters()}


def _halo(rank, world, inp):
    """Each halo module's forward and gradients (JAX's shard_map versions
    are the test's side)."""
    parts = make_parts(world)
    out = {}
    a, x = inp["A"], inp["x"]
    n = a.shape[0]
    for name, fn, plan in (("spmm", sharded_spmm, partition_graph(a, world)),
                           ("spmm_halo", sharded_spmm_halo,
                            partition_graph_halo(a, world))):
        rpp = plan.rows_per_part
        xs = torch.tensor(x[rank * rpp:(rank + 1) * rpp], requires_grad=True)
        full = gather_own(fn(plan.part(rank), xs, parts), parts)
        torch.tanh(full[:n]).sum().backward()
        out[name] = _np(full[:n])
        out[name + "_dx"] = _np(_gather_rows(xs.grad, parts))[:n]

    plan = partition_graph(a, world)
    rpp = plan.rows_per_part
    w = torch.tensor(inp["w"], requires_grad=True)
    xs = torch.tensor(x[rank * rpp:(rank + 1) * rpp])
    full = gather_own(sharded_gcn_layer(plan.part(rank), xs, w, None, parts),
                      parts)
    torch.tanh(full).sum().backward()
    all_reduce_grads([w], parts)
    out["gcn_layer_dw"] = _np(w.grad)

    mats, xc = inp["core_mats"], inp["xc"]
    n = xc.shape[0]
    ppyr = partition_pyramid_halo(mats, n, world)
    rpp = ppyr.rows_per_part
    xpad = np.zeros((ppyr.n_rows, xc.shape[1]), np.float32)
    xpad[:n] = xc
    for rnn_type, state in inp["layers"].items():
        layer = CoreDiffusion(xc.shape[1], state["norm.scale"].shape[0],
                              rnn_type=rnn_type)
        layer.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        xs = torch.tensor(xpad[rank * rpp:(rank + 1) * rpp],
                          requires_grad=True)
        full = gather_own(partitioned_core_diffusion(
            layer, xs, ppyr.part(rank), parts), parts)[:n]
        torch.tanh(full).sum().backward()
        all_reduce_grads(layer.parameters(), parts)
        out[f"cdn_{rnn_type}"] = _np(full)
        out[f"cdn_{rnn_type}_dx"] = _np(_gather_rows(xs.grad, parts))[:n]
        out[f"cdn_{rnn_type}_grads"] = _grads(layer)

    gcn_in = inp["gcn"]
    gcn = GCN(*gcn_in["dims"], dropout=0.0)
    gcn.load_state_dict({k: torch.from_numpy(v)
                         for k, v in gcn_in["state"].items()})
    hparts = [partition_graph_halo(m, world).part(rank)
              for m in gcn_in["mats"]]
    y = halo_gcn_forward(gcn, None, hparts, gcn_in["n"], parts)
    torch.tanh(y).sum().backward()
    Sharding(parts, "graph").reduce_grads(gcn)
    out["gcn"] = _np(y)
    out["gcn_grads"] = _grads(gcn)

    for name, spec in inp["core_models"].items():
        cls = CTGCN if name.startswith("CTGCN") else CGCN
        model = cls(*spec["dims"], **spec["kw"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in spec["state"].items()})
        k = max(len(m) for m in spec["mats"])
        hparts = [partition_pyramid_halo(m, spec["n"], world,
                                         num_slots=k).part(rank)
                  for m in spec["mats"]]
        res = halo_core_forward(model, None, hparts, spec["n"], parts)
        if model.model_type == "S":
            embs, trans = res
            loss = torch.tanh(embs).sum() + 0.5 * trans.square().sum()
            out[name + "_trans"] = _np(trans)
        else:
            embs = res
            loss = torch.tanh(embs).sum()
        loss.backward()
        Sharding(parts, "graph").reduce_grads(model)
        out[name] = _np(embs)
        out[name + "_grads"] = _grads(model)
    return out


def _pyramids(mats, n, k, keep):
    return stack_pyramids([build_core_pyramid(mats[t], n, num_slots=k)
                           for t in keep])


def _whole_state(sharding, model):
    """The whole model's ``state_dict``: assembled by ``sharding``, or the
    model's own on one part (no sharding)."""
    return (model.state_dict() if sharding is None
            else sharding.state_dict(model))


def _load_whole(sharding, model, state):
    """Load the whole model's ``state`` (numpy arrays) into the part's
    model."""
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    if sharding is None:
        model.load_state_dict(state)
    else:
        sharding.load_state_dict(model, state)


def _grad_state(sharding, model):
    """The whole model's gradients, keys as its ``state_dict`` (each
    parameter's data swapped for its gradient while ``_whole_state``
    assembles them; zeros where no loss reached it, as JAX gives)."""
    params = list(model.parameters())
    data = [p.data for p in params]
    for p in params:
        p.data = p.grad if p.grad is not None else torch.zeros_like(p)
    try:
        return {k: _np(v) for k, v in _whole_state(sharding, model).items()}
    finally:
        for p, d in zip(params, data):
            p.data = d


def _time(rank, world, inp):
    """The time-sharded step of each case (the pipelined one for a case
    with ``pipeline``): loss, the whole model's gradients and its
    parameters after one Adam step; and the gather's gradient rule."""
    parts = make_parts(world)
    out = {}
    for name, case in inp["cases"].items():
        T, n = len(case["mats"]), case["n"]
        model = CTGCN(*case["dims"], **case["kw"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["state"].items()})
        shard_time(model, parts, T)
        lo, hi = time_chunk(parts, T)
        k = max(len(m) for m in case["mats"])
        pipeline = case.get("pipeline", False)
        forward = ctgcn_pipelined_forward if pipeline else \
            time_sharded_forward
        res = forward(model, None, _pyramids(case["mats"], n, k,
                                             range(lo, hi)), parts)
        b_idx = torch.from_numpy(case["b_idx"]).long()
        b_mask = torch.from_numpy(case["b_mask"])
        if model.model_type == "S":
            loss = TL.reconstruction_loss(res[0], res[1], b_idx, b_mask)
        else:
            walk = TL.WalkData(**{kk: torch.from_numpy(v)
                                  for kk, v in case["walk"].items()})
            loss = TL.uneg_loss(res, b_idx, b_mask, walk,
                                torch.from_numpy(case["j"]),
                                torch.from_numpy(case["neg"]), Q=case["Q"])
        loss.backward()
        sharding = Sharding(parts, "time", time_length=T, pipeline=pipeline)
        sharding.reduce_grads(model)
        grad_state = _grad_state(sharding, model)
        make_optimizer(list(model.parameters()), case["lr"],
                       case["wd"]).step()
        out[name] = {"loss": float(loss),
                     "grads": grad_state,
                     "params": {kk: _np(v) for kk, v in
                                sharding.state_dict(model).items()},
                     "own": [lo, hi],
                     "own_keys": sorted(model.state_dict())}
    # the rule: every part computes the whole loss from the gathered x, so
    # x's gradient is the part's slice, once (not P times)
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = gather_own(x, parts)
    (y * torch.arange(1.0, 2 * world + 1)[:, None]).sum().backward()
    out["rule_y"] = _np(y)
    out["rule_dx"] = _np(_gather_rows(x.grad, parts))
    return out


#: what ``_cli`` returns of each window's results, where present
CLI_KEYS = ("idx", "parts", "core_backend", "losses", "acc_val",
            "best_acc_val", "acc_test")


def _cli(rank, world, inp):
    """The port's CLI under each of the test's configs (the method of
    ``inp["methods"][tag]``, else ``inp["method"]``); rank 0 writes the
    CSVs and the model file."""
    from ctgcn_torch import main as cli

    out = {}
    for tag, cfg in inp["configs"].items():
        method = inp.get("methods", {}).get(tag, inp.get("method"))
        res = cli.main([f"--config={cfg}", "--task=embedding",
                        f"--method={method}", "--device=cpu"])
        out[tag] = [{k: r[k] for k in CLI_KEYS if k in r} for r in res]
    return out


def _window(method, args, rng_seed=8):
    """The driver's trainer of window 0 of ``args`` (its layout over the
    group) on the CPU, the model drawn from a generator seeded 0 and the
    window's ``RandomState`` seeded ``rng_seed``."""
    from ctgcn_torch.training import driver as TD

    args = dict(args)
    loader = TD.get_data_loader(args)
    T = args["duration"]
    layout = TD.make_layout(method, args, T)
    trainer = TD.build_trainer(method, args, loader, 0, T,
                               torch.device("cpu"),
                               torch.Generator().manual_seed(0),
                               rng=np.random.RandomState(rng_seed),
                               layout=layout)
    return trainer, TD.make_forward(method, layout, loader.node_num, T), \
        layout


def _given(case):
    """The draws a case gives the forward: PGNN's anchor sets, VGRNN's
    noise."""
    extra = {}
    if "anchors" in case:
        extra["anchor_sets"] = [[torch.from_numpy(a) for a in sets]
                                for sets in case["anchors"]]
    if "noise" in case:
        extra["noise"] = [torch.from_numpy(z) for z in case["noise"]]
    return extra


def _zoo_step(rank, world, inp):
    """Each zoo method's U-neg step through the driver's layout over the
    group (the JAX parameters loaded through the sharding, the JAX
    sampler's draws): loss, the whole model's gradients and its
    parameters after one Adam step; and, under each method's config as
    written (its dropout), the forward with a generator seeded
    ``inp["seed"]`` and the generator's next draws after it.  A rank
    without a part (EvolveGCN and VGRNN run on one) skips the method."""
    out = {}
    for method, case in inp["cases"].items():
        trainer, fwd, layout = _window(method, case["config"])
        if trainer is None:
            continue
        model, sharding = trainer.model, trainer.sharding
        _load_whole(sharding, model, case["state"])
        res = fwd(model, trainer.data, None, **_given(case))
        embs = res[0] if method == "VGRNN" else res
        loss = TL.uneg_loss(embs, torch.from_numpy(case["b_idx"]).long(),
                            torch.from_numpy(case["b_mask"]),
                            trainer.data["walk"], torch.from_numpy(case["j"]),
                            torch.from_numpy(case["neg"]), Q=case["Q"])
        loss.backward()
        if sharding is not None:
            sharding.reduce_grads(model)
        grads = _grad_state(sharding, model)
        make_optimizer(list(model.parameters()), case["lr"],
                       case["wd"]).step()
        out[method] = {"loss": float(loss.detach()), "grads": grads,
                       "params": {k: _np(v) for k, v in
                                  _whole_state(sharding, model).items()},
                       "kind": layout[0], "parts": layout[1].count,
                       "own_keys": sorted(model.state_dict())}
    for method, case in inp["draws"].items():
        trainer, fwd, _ = _window(method, case["config"])
        trainer.sharding.load_state_dict(
            trainer.model, {k: torch.from_numpy(v)
                            for k, v in case["state"].items()})
        gen = torch.Generator().manual_seed(inp["seed"])
        res = fwd(trainer.model, trainer.data, gen)
        out[method]["drawn"] = _np(res[0] if method == "VGRNN" else res)
        out[method]["next"] = _np(torch.rand(8, generator=gen))
    return out


def _pipeline(rank, world, inp):
    """``pipelined_rnn_scan`` of each cell (its outputs, the cell's summed
    gradients and xs's gradient, gathered) and ``ctgcn_pipelined_forward``
    of each model (its outputs and the whole model's gradients, reduced by
    the pipeline's rule), for the loss sum(tanh(y) * w)."""
    parts = make_parts(world)
    out = {}
    xs, w = inp["xs"], torch.from_numpy(inp["w"])
    T, n = xs.shape[0], xs.shape[1]
    lo, hi = time_chunk(parts, T)
    for rnn_type, state in inp["cells"].items():
        cell = (GRUCell if rnn_type == "GRU" else LSTMCell)(
            xs.shape[2], state["w_hh"].shape[1])
        cell.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
        x = torch.tensor(xs[lo:hi], requires_grad=True)
        y = gather_own(pipelined_rnn_scan(cell, x, parts, inp["K"]), parts)
        (torch.tanh(y) * w).sum().backward()
        all_reduce_grads(cell.parameters(), parts)
        out[rnn_type] = {"y": _np(y), "grads": _grads(cell),
                         "dx": _np(_gather_rows(x.grad, parts))}
    for name, case in inp["models"].items():
        model = CTGCN(*case["dims"], **case["kw"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["state"].items()})
        shard_time(model, parts, T)
        k = max(len(m) for m in case["mats"])
        res = ctgcn_pipelined_forward(
            model, None, _pyramids(case["mats"], case["n"], k,
                                   range(lo, hi)), parts)
        embs, trans = res if model.model_type == "S" else (res, None)
        loss = (torch.tanh(embs) * torch.from_numpy(case["w"])).sum()
        if trans is not None:
            loss = loss + 0.5 * trans.square().sum()
        loss.backward()
        sharding = Sharding(parts, "time", time_length=T, pipeline=True)
        sharding.reduce_grads(model)
        out[name] = {"embs": _np(embs),
                     "trans": None if trans is None else _np(trans),
                     "grads": _grad_state(sharding, model)}
    return out


def _supervised_step(rank, world, inp):
    """Each supervised case's train step through the driver's layout over
    the group (the JAX parameters loaded, the JAX forward's draws given):
    loss, accuracy, the whole model's gradients and the classifier's,
    reduced by the sharding's rule, and both modules' parameters after one
    Adam step.  A rank without a part (VGRNN runs on one) skips the
    case."""
    import functools

    from ctgcn_torch.training import driver as TD

    out = {}
    for name, case in inp["cases"].items():
        method, cfg = case["method"], case["config"]
        trainer, fwd, layout = _window(method, cfg, rng_seed=cfg["seed"])
        if trainer is None:
            continue
        model, cls, sharding = (trainer.model, trainer.classifier,
                                trainer.sharding)
        _load_whole(sharding, model, case["state"])
        if cls is not None:
            cls.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in case["cls_state"].items()})
        given = _given(case)
        lt = cfg["learning_type"]
        if method == "VGRNN":
            trainer.forward_fn = TD._vgrnn_supervised_forward(
                functools.partial(fwd, **given), lt)
        elif given:
            trainer.forward_fn = TD._supervised_forward(
                functools.partial(fwd, **given), lt, False)
        state = (trainer.state_init(model, trainer.data)
                 if trainer.state_init is not None else None)
        loss, acc, *_ = trainer._run("train", None, state)
        loss.backward()
        modules = [model] + ([cls] if cls is not None else [])
        if sharding is not None:
            sharding.reduce_grads(model, *modules[1:])
        out[name] = {"loss": float(loss.detach()), "acc": float(acc),
                     "grads": _grad_state(sharding, model),
                     "cls_grads": None if cls is None else _grads(cls),
                     "kind": layout[0], "parts": layout[1].count}
        make_optimizer([p for m in modules for p in m.parameters()],
                       case["lr"], case["wd"]).step()
        out[name]["params"] = {k: _np(v) for k, v in
                               _whole_state(sharding, model).items()}
        out[name]["cls_params"] = (None if cls is None else
                                   {k: _np(v) for k, v in
                                    cls.state_dict().items()})
    return out


def _save(rank, world, inp):
    """Each case's model (``cls``: "CTGCN-C" or "GCRN", built from
    ``args``, loaded with the whole ``state``) time-sharded over the
    parts and saved at ``path`` through its sharding (rank 0 writes)."""
    parts = make_parts(world)
    for case in inp["cases"]:
        T = case["args"][-1]
        model = {"CTGCN-C": CTGCN, "GCRN": GCRN}[case["cls"]](*case["args"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["state"].items()})
        shard_time(model, parts, T)
        save_model_file(model, case["path"], Sharding(parts, "time",
                                                      time_length=T))
    return {}


JOBS = {"halo": _halo, "time": _time, "cli": _cli, "pipeline": _pipeline,
        "zoo_step": _zoo_step, "supervised_step": _supervised_step,
        "save": _save}


def main(rank, world, workdir, jobs):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    workdir = Path(workdir)
    init_from_env(torch.device("cpu"),
                  init_method=f"file://{workdir / 'store'}",
                  timeout=datetime.timedelta(seconds=60))
    try:
        for job in jobs:
            with open(workdir / f"{job}_in.pkl", "rb") as fp:
                inp = pickle.load(fp)
            out = JOBS[job](rank, world, inp)
            if rank == 0:
                with open(workdir / f"{job}_out.pkl", "wb") as fp:
                    pickle.dump(out, fp)
    finally:
        dist.destroy_process_group()
