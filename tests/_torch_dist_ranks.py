# coding: utf-8
"""Rank entry of ``tests/test_torch_dist.py``: one gloo process of a
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
from ctgcn_torch.nn.gcn import GCN
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
from ctgcn_torch.training.engine import make_optimizer


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


def _time(rank, world, inp):
    """The time-sharded step of each case: loss, the whole model's
    gradients and its parameters after one Adam step; and the gather's
    gradient rule."""
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
        res = time_sharded_forward(model, None,
                                   _pyramids(case["mats"], n, k,
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
        sharding = Sharding(parts, "time", time_length=T)
        sharding.reduce_grads(model)
        grads = CTGCN(*case["dims"], **case["kw"])
        shard_time(grads, parts, T)
        for g, p in zip(grads.parameters(), model.parameters()):
            g.data = p.grad.clone()
        grad_state = sharding.state_dict(grads)
        make_optimizer(list(model.parameters()), case["lr"],
                       case["wd"]).step()
        out[name] = {"loss": float(loss),
                     "grads": {kk: _np(v) for kk, v in grad_state.items()},
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


def _cli(rank, world, inp):
    """The port's CLI under each of the test's configs; rank 0 writes the
    CSVs and the model file."""
    from ctgcn_torch import main as cli

    out = {}
    for tag, cfg in inp["configs"].items():
        res = cli.main([f"--config={cfg}", "--task=embedding",
                        f"--method={inp['method']}", "--device=cpu"])
        out[tag] = [{k: r[k] for k in ("idx", "parts", "core_backend",
                                       "losses")} for r in res]
    return out


JOBS = {"halo": _halo, "time": _time, "cli": _cli}


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
