# coding: utf-8
"""UCI Had AUC of GCRN, EvolveGCN and TgGCN trained by the JAX package or
by the port, on the CPU: the figures ``chip_smoke.py``'s ``[quality]``
holds the card's runs of these three against.

A copy of ``data/uci`` is preprocessed as ``configs/uci.json``'s
"CTGCN-C" entry gives it (k-core pyramids, the walk tables the three
methods' entries name), by the package under test.  Each method then runs
its entry as written (U-neg, 50 epochs; GCRN and EvolveGCN one window of
duration 7, TgGCN seven windows of duration 1), once per seed, and the
port's ``link_pred`` as the config gives it scores every run over
edge-split reps 0-2; each run's figure is the mean Had AUC of the last 4
dates.

Trained by ``ctgcn_tpu`` (``--package jax``) or ``ctgcn_torch``
(``--package torch``, on the CPU).  Prints one JSON line a method: each
seed's and rep's figure, their mean and standard deviations.

    JAX_PLATFORMS=cpu python scripts/zoo_quality_reference.py \\
        --package jax --seeds 0 1 --work /tmp/zoo_quality
"""
import argparse
import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 3
METHODS = ("GCRN", "EvolveGCN", "TgGCN")


def _package(package):
    """(preprocess(args), train(method, args)) of ``package``."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ctgcn_tpu.preprocessing import preprocess
        from ctgcn_tpu.training.driver import gnn_embedding

        return (lambda args: preprocess("CTGCN-C", args)), gnn_embedding
    from ctgcn_torch.preprocessing import preprocess
    from ctgcn_torch.training.driver import gnn_embedding

    def train(method, args):
        return gnn_embedding(method, args, device="cpu")

    return (lambda args: preprocess("CTGCN-C", args)), train


def run(package, methods, seeds, work):
    from ctgcn_torch import main as cli
    from ctgcn_torch.evaluation.tables import read_table

    preprocess, train = _package(package)
    base = work / "uci"
    if base.exists():
        shutil.rmtree(base)
    for folder in ("1.format", "nodes_set"):
        shutil.copytree(ROOT / "data" / "uci" / folder, base / folder)
    with open(ROOT / "configs" / "uci.json") as fp:
        conf = json.load(fp)
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess(dict(conf["preprocessing"]["CTGCN-C"],
                        base_path=str(base)))
    names = {}
    for method in methods:
        for seed in seeds:
            name = f"{method}-{package}-s{seed}"
            args = dict(conf["embedding"][method], base_path=str(base),
                        seed=seed, embed_folder=f"2.embedding/{name}",
                        model_file=name, record_time=False)
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
                    "epochs": conf["embedding"][method]["epoch"],
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
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--work", type=Path, required=True,
                        help="scratch directory for the data copy")
    opts = parser.parse_args(argv)
    for line in run(opts.package, opts.methods, opts.seeds, opts.work):
        print(json.dumps({"package": opts.package, **line}), flush=True)


if __name__ == "__main__":
    main()
