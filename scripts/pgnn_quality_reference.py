# coding: utf-8
"""PGNN's quality when trained by the JAX package or by the port, on the
CPU: the figures ``chip_smoke.py``'s ``[quality]`` holds PGNN's card runs
against.

  * ``uci``: ``configs/uci.json`` "PGNN" as written (S-link-st, duration 2,
    so four windows, 50 epochs), trained once per seed on a copy of
    ``data/uci``, then scored as ``[quality]`` scores it: the port's
    ``link_pred`` as the config gives it over edge-split reps 0-2, the
    mean Had AUC of the last 4 dates.
  * ``aa``: ``configs/america-air.json`` "PGNN" as written (S-node, hid
    500) on its first window (snapshot 0), once per seed: the test
    accuracy of the best-on-validation parameters.

Trained by ``ctgcn_tpu`` (``--package jax``; the global ``np.random``,
which draws its link splits, seeded with the run's seed) or
``ctgcn_torch`` (``--package torch``, on the CPU).  Prints one JSON line:
each seed's (and rep's) figure, their mean and standard deviation.

    JAX_PLATFORMS=cpu python scripts/pgnn_quality_reference.py \\
        --package jax --seeds 0 1 2 3 --work /tmp/pgnn_quality
"""
import argparse
import contextlib
import io
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 3
RESULT = re.compile(r"Test set results: loss= (\S+) accuracy= (\S+) "
                    r"auc= (\S+)")


def _trainer(package):
    """(method, args) -> the test accuracy of the first window."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ctgcn_tpu.training.driver import gnn_embedding

        def train(method, args):
            np.random.seed(args["seed"])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                gnn_embedding(method, args)
            return float(RESULT.findall(out.getvalue())[0][1])
    else:
        from ctgcn_torch.training.driver import gnn_embedding

        def train(method, args):
            with contextlib.redirect_stdout(io.StringIO()):
                return gnn_embedding(method, args, device="cpu")[0][
                    "acc_test"]
    return train


def _copy(name, folders, work):
    base = work / name
    if base.exists():
        shutil.rmtree(base)
    for folder in folders:
        shutil.copytree(ROOT / "data" / name / folder, base / folder)
    return base


def run_uci(train, package, seeds, work):
    from ctgcn_torch import main as cli
    from ctgcn_torch.evaluation.tables import read_table

    base = _copy("uci", ("1.format", "nodes_set"), work)
    with open(ROOT / "configs" / "uci.json") as fp:
        conf = json.load(fp)
    names = []
    for seed in seeds:
        name = f"PGNN-{package}-s{seed}"
        train("PGNN", dict(conf["embedding"]["PGNN"], base_path=str(base),
                           seed=seed, embed_folder=f"2.embedding/{name}",
                           model_file=name, record_time=False))
        names.append(name)
    lp = dict(conf["link_pred"], base_path=str(base), start_idx=0,
              rep_num=REPS, method_list=names, aggregate=True)
    path = base / "link_pred.json"
    path.write_text(json.dumps({"link_pred": lp}))
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main([f"--config={path}", "--task=link_pred", "--device=cpu"])
    had = {}
    for name in names:
        had[name] = []
        for i in range(REPS):
            header, cols = read_table(
                base / f"lp_res_{i}" / f"{name}_auc_record.csv", ",")
            had[name].append(float(np.mean(cols[header.index("Had")][-4:])))
    flat = [v for reps in had.values() for v in reps]
    seed_means = [float(np.mean(v)) for v in had.values()]
    return {"data": "uci", "learning_type": "S-link-st",
            "epochs": conf["embedding"]["PGNN"]["epoch"],
            "had_auc_last4_by_seed_and_rep": had,
            "had_auc_mean": float(np.mean(flat)),
            "std_over_seeds_and_reps": float(np.std(flat, ddof=1)),
            "std_of_seed_means": float(np.std(seed_means, ddof=1))
            if len(seed_means) > 1 else None}


def run_aa(train, package, seeds, work):
    base = _copy("america_air", ("1.format", "nodes_set", "nodes_label"),
                 work)
    with open(ROOT / "configs" / "america-air.json") as fp:
        conf = json.load(fp)
    acc = {}
    for seed in seeds:
        name = f"PGNN-{package}-s{seed}"
        acc[seed] = train("PGNN", dict(
            conf["embedding"]["PGNN"], base_path=str(base), seed=seed,
            end_idx=0, embed_folder=f"2.embedding/{name}", model_file=name,
            cls_file=f"{name}_cls", record_time=False))
    vals = list(acc.values())
    return {"data": "america_air", "learning_type": "S-node", "window": 0,
            "epochs": conf["embedding"]["PGNN"]["epoch"],
            "acc_test_by_seed": acc, "acc_test_mean": float(np.mean(vals)),
            "std_over_seeds": float(np.std(vals, ddof=1))
            if len(vals) > 1 else None}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=("jax", "torch"),
                        required=True)
    parser.add_argument("--runs", nargs="+", choices=("uci", "aa"),
                        default=["uci", "aa"])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--work", type=Path, required=True,
                        help="scratch directory for the data copies")
    opts = parser.parse_args(argv)
    train = _trainer(opts.package)
    runs = {"uci": run_uci, "aa": run_aa}
    for name in opts.runs:
        print(json.dumps({"package": opts.package, "seeds": opts.seeds,
                          **runs[name](train, opts.package, opts.seeds,
                                       opts.work)}), flush=True)


if __name__ == "__main__":
    main()
