# coding: utf-8
"""The non-GNN baselines' quality when trained by the JAX package or by
the port, on the CPU: the figures ``chip_smoke.py``'s ``[quality]`` holds
the card's UCI runs of DynGEM, DynAE, DynRNN, DynAERNN and TIMERS against.

Each method runs ``configs/uci.json``'s entry as written (DynGEM: every
snapshot, 50 epochs; DynAE, DynRNN, DynAERNN: windows 2-6, look-back 2,
50 epochs; TIMERS: every snapshot), once per seed, on a copy of
``data/uci``; then the port's ``link_pred`` as the config gives it scores
every run over edge-split reps 0-2, and each run's figure is the mean Had
AUC of the last 4 dates.  TIMERS draws nothing but ARPACK's start, which
both packages here start from the ones vector (the JAX package's ``svds``
and ``eigs`` are wrapped for this script only), so it runs once.

Trained by ``ctgcn_tpu`` (``--package jax``) or ``ctgcn_torch``
(``--package torch``, on the CPU).  Prints one JSON line a method: each
seed's and rep's figure, their mean and standard deviations.

    JAX_PLATFORMS=cpu python scripts/dyn_quality_reference.py \\
        --package jax --seeds 0 1 --rnn-seeds 0 --work /tmp/dyn_quality
"""
import argparse
import contextlib
import functools
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 3
METHODS = ("DynGEM", "DynAE", "DynRNN", "DynAERNN", "TIMERS")


def _pinned(fn, v0_size):
    """``fn`` (scipy's ``svds`` or ``eigs``) started from the ones vector."""

    @functools.wraps(fn)
    def call(A, k, *args, **kw):
        kw.setdefault("v0", np.ones(v0_size(A.shape)))
        return fn(A, k, *args, **kw)

    return call


def _trainer(package):
    """(method, args) -> None: one training run of ``method``."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ctgcn_tpu.nn import timers as jtimers
        from ctgcn_tpu.nn.dynae import dyngem_embedding

        jtimers.svds = _pinned(jtimers.svds, min)
        jtimers.eigs = _pinned(jtimers.eigs, lambda shape: shape[0])

        def train(method, args):
            if method == "TIMERS":
                jtimers.timers_embedding(args)
            else:
                dyngem_embedding(method, args)
    else:
        from ctgcn_torch.nn.dynae import dyngem_embedding
        from ctgcn_torch.nn.timers import timers_embedding

        def train(method, args):
            if method == "TIMERS":
                timers_embedding(args, device="cpu")
            else:
                dyngem_embedding(method, args, device="cpu")
    return train


def run(train, package, methods, seeds, rnn_seeds, work):
    from ctgcn_torch import main as cli
    from ctgcn_torch.evaluation.tables import read_table

    base = work / "uci"
    if base.exists():
        shutil.rmtree(base)
    for folder in ("1.format", "nodes_set"):
        shutil.copytree(ROOT / "data" / "uci" / folder, base / folder)
    with open(ROOT / "configs" / "uci.json") as fp:
        conf = json.load(fp)
    names = {}
    for method in methods:
        runs = ((None,) if method == "TIMERS"
                else rnn_seeds if method == "DynRNN" else seeds)
        for seed in runs:
            name = f"{method}-{package}" + ("" if seed is None
                                            else f"-s{seed}")
            args = dict(conf["embedding"][method], base_path=str(base),
                        embed_folder=f"2.embedding/{name}",
                        record_time=False)
            if seed is not None:
                args.update(seed=seed, model_file=name)
            with contextlib.redirect_stdout(io.StringIO()):
                train(method, args)
            names.setdefault(method, []).append(name)
    lp = dict(conf["link_pred"], base_path=str(base), start_idx=0,
              rep_num=REPS, method_list=[n for v in names.values() for n in v],
              aggregate=True)
    path = base / "link_pred.json"
    path.write_text(json.dumps({"link_pred": lp}))
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main([f"--config={path}", "--task=link_pred", "--device=cpu"])
    out = []
    for method, runs in names.items():
        had = {}
        for name in runs:
            had[name] = []
            for i in range(REPS):
                header, cols = read_table(
                    base / f"lp_res_{i}" / f"{name}_auc_record.csv", ",")
                had[name].append(
                    float(np.mean(cols[header.index("Had")][-4:])))
        flat = [v for reps in had.values() for v in reps]
        seed_means = [float(np.mean(v)) for v in had.values()]
        out.append({"method": method, "data": "uci",
                    "epochs": conf["embedding"][method].get("epoch"),
                    "had_auc_last4_by_seed_and_rep": had,
                    "had_auc_mean": float(np.mean(flat)),
                    "std_over_seeds_and_reps": float(np.std(flat, ddof=1)),
                    "std_of_seed_means": float(np.std(seed_means, ddof=1))
                    if len(seed_means) > 1 else None})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=("jax", "torch"),
                        required=True)
    parser.add_argument("--methods", nargs="+", choices=METHODS,
                        default=list(METHODS))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1],
                        help="seeds of DynGEM, DynAE and DynAERNN")
    parser.add_argument("--rnn-seeds", type=int, nargs="+", default=[0],
                        help="seeds of DynRNN (its N-wide LSTM is the slow "
                             "one on a CPU)")
    parser.add_argument("--work", type=Path, required=True,
                        help="scratch directory for the data copy")
    opts = parser.parse_args(argv)
    for line in run(_trainer(opts.package), opts.package, opts.methods,
                    opts.seeds, opts.rnn_seeds, opts.work):
        print(json.dumps({"package": opts.package, **line}), flush=True)


if __name__ == "__main__":
    main()
