# coding: utf-8
"""Embedding-task driver (port of ``ctgcn_tpu/training/driver.py`` for
CTGCN-C with the U-neg learning type).

Per window: load the k-core pyramids (on the config's ``core_backend``,
``"auto"`` by default) and walk tables, build a fresh CTGCN, train it with
the negative-sampling loss, export the per-timestamp embedding CSVs, and
record the window's training seconds in ``<base_path>/<method>_time.csv``
after every window.

The JAX driver's memory knobs, which it reads from ``CTGCN_TPU_*``
environment variables, reach the model as constructor arguments here:
``layer_remat`` from the config, as in the JAX driver, and the byte
budgets at their module defaults (``ACT_BUDGET``, ``CVJP_BATCH_BUDGET``).
"""
from __future__ import annotations

import functools
import os
import time

import torch

from ctgcn_torch.data.formats import read_node_list, write_time_csv
from ctgcn_torch.data.loader import DataLoader
from ctgcn_torch.losses import negative_sampling_loss
from ctgcn_torch.nn.core_models import ACT_BUDGET, CTGCN
from ctgcn_torch.ops.rnn import CVJP_BATCH_BUDGET
from ctgcn_torch.training.engine import UnsupervisedEmbedding
from ctgcn_torch.utils import resolve_device

PORTED_METHODS = ("CTGCN-C",)
PORTED_LEARNING_TYPES = ("U-neg",)


def _check_scope(method, args):
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md queue 1: "
            "CGCN and the S-variants item 9, the model zoo item 12)")
    lt = args["learning_type"]
    if lt not in PORTED_LEARNING_TYPES:
        raise NotImplementedError(
            f"learning_type {lt!r} is not ported yet (ROADMAP.md queue 1: "
            "U-own item 9, supervised types item 10)")
    if args.get("remat_policy", "full") != "full":
        raise NotImplementedError(
            "remat_policy 'save_spmm' is not ported yet; only 'full'")
    if args.get("nfeature_folder"):
        raise NotImplementedError(
            "file node features are not ported yet (ROADMAP.md queue 1, "
            "item 9); CTGCN-C runs on identity features")
    if args.get("n_devices", 0) > 1:
        raise NotImplementedError(
            "multi-device runs are not ported yet (ROADMAP.md queue 1, "
            "item 13)")
    prec = args.get("matmul_precision", "highest")
    if prec != "highest":
        raise NotImplementedError(
            f"matmul_precision {prec!r} is not ported yet (ROADMAP.md "
            "queue 1, item 2: it needs a bf16 bank and bf16 gathers in the "
            "kernels); only 'highest'")


def get_data_loader(args):
    """DataLoader over the config's node list; records the absolute
    artifact paths and ``node_num`` in ``args``."""
    base_path = args["base_path"]
    origin_folder = args["origin_folder"]
    core_folder = args.get("core_folder")
    node_list = read_node_list(
        os.path.abspath(os.path.join(base_path, args["node_file"])))
    origin_base_path = (os.path.abspath(os.path.join(base_path,
                                                     origin_folder))
                        if origin_folder else None)
    core_base_path = (os.path.abspath(os.path.join(base_path, core_folder))
                      if core_folder else None)
    max_time_num = len(os.listdir(origin_base_path or core_base_path))
    if max_time_num == 0:
        raise ValueError(f"no snapshots under {origin_base_path}")
    args["origin_base_path"] = origin_base_path
    args["core_base_path"] = core_base_path
    args["node_num"] = len(node_list)
    return DataLoader(node_list, max_time_num)


def get_input_data(method, idx, time_length, data_loader: DataLoader, args):
    """(input_dim, stacked CorePyramid, xs) for one window on the host;
    xs is None: identity node features, never materialized."""
    del method
    pyramids = data_loader.get_core_adj_list(
        args["core_base_path"], idx, time_length,
        max_core=args.get("max_core", -1),
        core_backend=args.get("core_backend", "auto"),
        dense_budget_bytes=args.get("dense_budget_bytes", 4 << 30))
    return data_loader.node_num, pyramids, None


def get_gnn_model(method, time_length, args, generator):
    """A fresh CTGCN for one window, parameters drawn from ``generator``."""
    del method
    return CTGCN(args["input_dim"], args["hid_dim"], args["embed_dim"],
                 trans_num=args["trans_layer_num"],
                 diffusion_num=args["diffusion_layer_num"],
                 duration=time_length, bias=args.get("bias", True),
                 rnn_type=args.get("rnn_type", "GRU"),
                 model_type=args["model_type"],
                 trans_activate_type=args.get("trans_activate_type", "L"),
                 generator=generator,
                 act_budget=ACT_BUDGET,
                 layer_remat=bool(args.get("layer_remat", False)),
                 cvjp_batch_budget=CVJP_BATCH_BUDGET)


@functools.lru_cache(maxsize=None)
def _uneg_loss_fn(neg_num, Q):
    def loss_fn(model, data, b_idx, b_mask, generator):
        embs = model(data["xs"], data["adjs"])
        return negative_sampling_loss(embs, b_idx, b_mask, data["walk"],
                                      generator, neg_num=neg_num, Q=Q)

    return loss_fn


def _embed_fn(model, data):
    return model(data["xs"], data["adjs"])


def build_trainer(method, args, data_loader, idx, time_length, device,
                  generator):
    """The window's inputs on ``device``, a fresh model drawn from
    ``generator``, and the U-neg trainer over them."""
    base_path = args["base_path"]
    input_dim, pyramids, xs = get_input_data(method, idx, time_length,
                                             data_loader, args)
    args["input_dim"] = input_dim
    walk = data_loader.get_walk_data(
        os.path.abspath(os.path.join(base_path, args["walk_pair_folder"])),
        os.path.abspath(os.path.join(base_path, args["node_freq_folder"])),
        idx, time_length)
    data = {"adjs": pyramids.to(device), "xs": xs, "walk": walk.to(device)}
    model = get_gnn_model(method, time_length, args, generator).to(device)
    return UnsupervisedEmbedding(
        base_path=base_path, origin_folder=args["origin_folder"],
        embedding_folder=args["embed_folder"],
        node_list=data_loader.full_node_list, model=model,
        loss_fn=_uneg_loss_fn(args["neg_num"], args["Q"]),
        embed_fn=_embed_fn, data=data, device=device,
        model_folder=args.get("model_folder", "model"),
        file_sep=args.get("file_sep", "\t"))


def gnn_embedding(method, args, device="cuda"):
    """Run the embedding task over all windows of the config.

    Returns one dict per window: ``idx``, ``setup_seconds`` (loading the
    window and building its model, on the host clock) and what
    ``UnsupervisedEmbedding.learn_embedding`` returns."""
    _check_scope(method, args)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # full-f32 GEMMs around the SpMM kernels (the JAX package's
        # Precision.HIGHEST)
        torch.backends.cuda.matmul.allow_tf32 = False
    base_path = args["base_path"]
    model_file = args.get("model_file", method.lower())
    start_idx = args["start_idx"]
    end_idx = args["end_idx"]
    duration = args["duration"]
    load_model = args.get("load_model", False)
    record_time = args.get("record_time", False)
    seed = args.get("seed", 0)

    data_loader = get_data_loader(args)
    max_time_num = data_loader.max_time_num
    if start_idx < 0:
        start_idx = max_time_num + start_idx
    end_idx = max_time_num + end_idx + 1 if end_idx < 0 else end_idx + 1
    step = duration

    t_start = time.time()
    time_list, results = [], []
    print(f"start_idx = {start_idx}, end_idx = {end_idx}, "
          f"duration = {duration}")
    print(f"start {method} embedding! (ctgcn_torch on {dev})")
    gen = torch.Generator().manual_seed(seed)
    for widx, idx in enumerate(range(start_idx, end_idx, step)):
        print(f"idx = {idx}, duration = {duration}")
        time_length = min(idx + duration, end_idx) - idx
        t_setup = time.time()
        trainer = build_trainer(method, args, data_loader, idx, time_length,
                                dev, gen)
        setup_seconds = time.time() - t_setup
        # every window overwrites the same model file; only the last
        # window's save is kept unless the run reloads models
        is_last = idx + step >= end_idx
        res = trainer.learn_embedding(
            epoch=args["epoch"], batch_size=args["batch_size"], lr=args["lr"],
            start_idx=idx, weight_decay=args.get("weight_decay", 0.0),
            model_file=model_file if (is_last or load_model) else None,
            load_model=load_model, shuffle=args.get("shuffle", True),
            export=args.get("export", True), seed=seed + widx)
        time_list.append(res["cost_time"])
        results.append({"idx": idx, "setup_seconds": setup_seconds,
                        "core_backend": trainer.data["adjs"].backend, **res})
        if record_time:
            write_time_csv(os.path.join(base_path, method + "_time.csv"),
                           time_list)
    print(f"finish {method} embedding! cost time: "
          f"{time.time() - t_start} seconds!")
    return results
