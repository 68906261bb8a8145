# coding: utf-8
"""Test accuracy of the JAX package's CTGCN-C under S-node on America-Air.

``configs/america-air.json`` "CTGCN-C" as written (hid 500, embed 128,
duration 10, 50 epochs, the ``nodes_label`` split 0.5/0.3/0.2) with
``learning_type: "S-node"``, trained once per seed on a preprocessed copy
of ``data/america_air``; each seed's test accuracy and AUC, and their
means.  ``chip_smoke.py`` holds the port's ``aa_snode`` quality run against
the mean this prints (``AA_SNODE_JAX_ACC``).  The global ``np.random`` is
seeded with the run's seed, as the port seeds its split generator.

    JAX_PLATFORMS=cpu python scripts/jax_snode_reference.py \
        --seeds 0 1 --work /tmp/aa_snode
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

RESULT = re.compile(r"Test set results: loss= (\S+) accuracy= (\S+) "
                    r"auc= (\S+)")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--epochs", type=int, default=None,
                        help="default: the config's (50)")
    parser.add_argument("--work", type=Path, required=True,
                        help="scratch directory for the preprocessed copy")
    opts = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from ctgcn_tpu.preprocessing import preprocess
    from ctgcn_tpu.training.driver import gnn_embedding

    base = opts.work / "america_air"
    if base.exists():
        shutil.rmtree(base)
    for folder in ("1.format", "nodes_set", "nodes_label"):
        shutil.copytree(ROOT / "data" / "america_air" / folder, base / folder)
    with open(ROOT / "configs" / "america-air.json") as fp:
        conf = json.load(fp)
    preprocess("CTGCN-C", dict(conf["preprocessing"]["CTGCN-C"],
                               base_path=str(base)))
    runs = []
    for seed in opts.seeds:
        emb = dict(conf["embedding"]["CTGCN-C"], base_path=str(base),
                   learning_type="S-node", seed=seed,
                   embed_folder=f"2.embedding/snode-s{seed}")
        if opts.epochs is not None:
            emb["epoch"] = opts.epochs
        np.random.seed(seed)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            gnn_embedding("CTGCN-C", emb)
        found = RESULT.findall(out.getvalue())
        if len(found) != 1:
            raise RuntimeError(f"seed {seed}: {len(found)} test results in "
                               f"the run's output")
        loss, acc, auc = (float(v) for v in found[0])
        runs.append({"seed": seed, "epochs": emb["epoch"], "test_loss": loss,
                     "test_acc": acc, "test_auc": auc})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"mean_test_acc": float(np.mean([r["test_acc"]
                                                      for r in runs])),
                      "mean_test_auc": float(np.mean([r["test_auc"]
                                                      for r in runs])),
                      "runs": runs}))


if __name__ == "__main__":
    main()
