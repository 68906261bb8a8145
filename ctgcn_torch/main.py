# coding: utf-8
"""CLI of the PyTorch port, with the JAX package's flags plus ``--device``:

    python -m ctgcn_torch.main --config=<json> --task=<task> \
        [--method=<M>] [--device=cuda|cpu]

Tasks ported so far: ``preprocessing`` and ``embedding`` (CTGCN-C, U-neg).
The device defaults to ``cuda``; without a GPU the run stops unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys

from ctgcn_torch.utils import get_supported_methods, resolve_device

#: ROADMAP.md item that brings each task the port does not have yet
_MISSING_TASKS = {
    "link_pred": "queue 1, item 8",
    "node_cls": "queue 1, item 8",
    "edge_cls": "queue 1, item 8",
    "cent_pred": "queue 1, item 8",
    "sim_pred": "queue 1, item 8",
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
    one result dict per window)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    with open(args.config[0]) as fp:
        config = json.load(fp)
    if args.task in ("preprocessing", "embedding") and args.method is None:
        raise AttributeError(
            f"method parameter is needed for the {args.task} task!")
    if args.task == "preprocessing":
        from ctgcn_torch.preprocessing import preprocess

        return preprocess(args.method, config[args.task][args.method])
    if args.task == "embedding":
        if args.method not in get_supported_methods():
            raise ValueError(f"unknown method {args.method!r}")
        from ctgcn_torch.training.driver import gnn_embedding

        return gnn_embedding(args.method, config[args.task][args.method],
                             device=device)
    if args.task in _MISSING_TASKS:
        raise NotImplementedError(
            f"task {args.task!r} is not ported yet "
            f"(ROADMAP.md {_MISSING_TASKS[args.task]})")
    raise AttributeError(f"Unsupported task {args.task!r}!")


if __name__ == "__main__":
    main()
