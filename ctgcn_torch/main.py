# coding: utf-8
"""CLI of the PyTorch port, with the JAX package's flags plus ``--device``:

    python -m ctgcn_torch.main --config=<json> --task=<task> \
        [--method=<M>] [--device=cuda|cpu]

Tasks: ``preprocessing`` (k-core pyramids and walk tables, on the native
host-graph kernels), ``embedding`` (every method the JAX package runs:
CGCN-C, CGCN-S, CTGCN-C and CTGCN-S under the config's learning type,
U-neg, U-own for the S-variants, S-node, S-edge, S-link-st or S-link-dy;
the zoo's GCN, TgGCN, GIN, TgGIN, GAT, TgGAT, SAGE, TgSAGE, GCRN,
EvolveGCN, VGRNN and PGNN under U-neg and the supervised types, and VGRNN
under U-own; the non-GNN DynGEM, DynAE, DynRNN and DynAERNN, trained by
``nn.dynae.dyngem_embedding``, and TIMERS, host linear algebra in
``nn.timers.timers_embedding``), and the five evaluation tasks
``link_pred``,
``node_cls``, ``edge_cls``, ``cent_pred`` and ``sim_pred``, whose fits,
metrics and centralities run on the device.
The device defaults to ``cuda``; without a GPU the run stops unless
``--device cpu`` is given.

Under ``torchrun`` (one process a GPU; WORLD_SIZE and the rest in the
environment) the process group is initialized at entry (NCCL, or gloo with
``--device cpu``) and ``cuda`` means ``cuda:LOCAL_RANK``.  The CTGCN family
and the zoo split the embedding task's windows over the ranks as the
config's ``n_devices`` / ``graph_partition`` say (``training.driver``);
every other task, and the non-GNN methods, run on rank 0 alone.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch.distributed as dist

from ctgcn_torch.parallel.dist import init_from_env, is_primary
from ctgcn_torch.utils import (NON_GNN_METHODS, get_supported_methods,
                               resolve_device)

#: evaluation task -> (module, function) of ``ctgcn_torch.evaluation``
EVAL_TASKS = {
    "link_pred": ("link_prediction", "link_prediction"),
    "node_cls": ("node_classification", "node_classification"),
    "edge_cls": ("edge_classification", "edge_classification"),
    "cent_pred": ("centrality_prediction", "centrality_prediction"),
    "sim_pred": ("similarity_prediction", "similarity_prediction"),
}


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="ctgcn_torch",
        description="K-core Temporal Graph Convolutional Network "
                    "(PyTorch/CUDA port)")
    parser.add_argument("--config", nargs=1, type=str, required=True,
                        help="configuration file path")
    parser.add_argument("--task", type=str, required=True,
                        help="task name to run")
    parser.add_argument("--method", type=str, default=None,
                        help="embedding method (embedding/preprocessing task)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Run one task; returns what the task returns (the embedding task:
    one result dict per window, TIMERS' one per snapshot; an evaluation
    task: its seconds)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    started = init_from_env(device)
    try:
        return _run(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, device):
    with open(args.config[0]) as fp:
        config = json.load(fp)
    if args.task in ("preprocessing", "embedding") and args.method is None:
        raise AttributeError(
            f"method parameter is needed for the {args.task} task!")
    split = (args.task == "embedding"
             and args.method not in NON_GNN_METHODS)
    if not (split or is_primary()):
        return None
    if args.task == "preprocessing":
        from ctgcn_torch.preprocessing import preprocess

        return preprocess(args.method, config[args.task][args.method])
    if args.task == "embedding":
        if args.method not in get_supported_methods():
            raise ValueError(f"unknown method {args.method!r}")
        section = config[args.task][args.method]
        if args.method == "TIMERS":
            from ctgcn_torch.nn.timers import timers_embedding

            return timers_embedding(section, device=device)
        if args.method in NON_GNN_METHODS:
            from ctgcn_torch.nn.dynae import dyngem_embedding

            return dyngem_embedding(args.method, section, device=device)
        from ctgcn_torch.training.driver import gnn_embedding

        return gnn_embedding(args.method, section, device=device)
    if args.task in EVAL_TASKS:
        module, fn = EVAL_TASKS[args.task]
        task = getattr(importlib.import_module(
            f"ctgcn_torch.evaluation.{module}"), fn)
        return task(config[args.task], device=device)
    raise AttributeError(f"Unsupported task {args.task!r}!")


if __name__ == "__main__":
    main()
