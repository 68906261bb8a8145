# coding: utf-8
"""UCI Had AUC of VGRNN trained by the JAX package or by the port, on the
CPU.

``configs/uci.json`` "VGRNN" as written (U-own, T = 7, hid 500, embed 128,
50 epochs), trained once per seed on a copy of ``data/uci`` by
``ctgcn_tpu`` (``--package jax``) or ``ctgcn_torch`` (``--package torch``,
with ``--device cpu``), then scored as ``chip_smoke.py``'s ``[quality]``
scores it: the port's ``link_pred`` as the config gives it over edge-split
reps 0-2, the mean Had AUC of the last 4 dates.  Prints each seed's and
rep's figure and their mean.

    JAX_PLATFORMS=cpu python scripts/vgrnn_quality_reference.py \
        --package jax --seeds 0 1 --work /tmp/vgrnn_quality
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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=("jax", "torch"),
                        required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--work", type=Path, required=True,
                        help="scratch directory for the UCI copy")
    opts = parser.parse_args(argv)

    if opts.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ctgcn_tpu.training.driver import gnn_embedding

        train = gnn_embedding
    else:
        from ctgcn_torch.training.driver import gnn_embedding

        def train(method, args):
            return gnn_embedding(method, args, device="cpu")
    from ctgcn_torch import main as cli
    from ctgcn_torch.evaluation.tables import read_table

    base = opts.work / "uci"
    if base.exists():
        shutil.rmtree(base)
    for folder in ("1.format", "nodes_set"):
        shutil.copytree(ROOT / "data" / "uci" / folder, base / folder)
    with open(ROOT / "configs" / "uci.json") as fp:
        conf = json.load(fp)
    names = []
    for seed in opts.seeds:
        name = f"VGRNN-{opts.package}-s{seed}"
        emb = dict(conf["embedding"]["VGRNN"], base_path=str(base), seed=seed,
                   embed_folder=f"2.embedding/{name}", model_file=name,
                   record_time=False)
        with contextlib.redirect_stdout(io.StringIO()):
            train("VGRNN", emb)
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
    print(json.dumps({"package": opts.package, "epochs":
                      conf["embedding"]["VGRNN"]["epoch"],
                      "had_auc_last4_by_seed_and_rep": had,
                      "had_auc_mean": float(np.mean(
                          [np.mean(v) for v in had.values()]))}))


if __name__ == "__main__":
    main()
