"""The tiny copy of the benchmark (``tiny.make_checkout``) with one more
cell: ``vgrnn.tiny.uown`` (VGRNN under U-own, at the tiny widths, node
batches of 24, so 3 batches an epoch carry h)."""
from __future__ import annotations

import json
import os

import tiny

CELLS = ("vgrnn.tiny.uown",)
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "step_gap": 1e-3,
          "embed_gap": 1e-4}
GRAM_LIMITS = {"sum_gap": 1e-5, "grad_gap": 1e-5}


def _load(path):
    with open(path) as fp:
        return json.load(fp)


def _dump(path, obj):
    with open(path, "w") as fp:
        json.dump(obj, fp)


def make_checkout(dest):
    """``tiny.make_checkout``'s checkout with the cell added."""
    tiny.make_checkout(dest)
    gb = os.path.join(dest, "gpubench")
    cfg = _load(os.path.join(tiny.GPUBENCH, "configs", "vgrnn.enron.json"))
    cfg.update(tiny.WIDTHS, name="vgrnn.tiny", data="tiny")
    _dump(os.path.join(gb, "configs", "vgrnn.tiny.json"), cfg)
    traffic = _load(os.path.join(gb, "traffic", "uown.json"))
    traffic["program"]["batch_size"] = tiny.JOB["batch_size"]
    _dump(os.path.join(gb, "traffic", "uown.json"), traffic)
    bench = _load(os.path.join(dest, "BENCHMARK.json"))
    bench["configs"].append({"name": "vgrnn.tiny", "source": "tiny",
                             "file": "gpubench/configs/vgrnn.tiny.json",
                             "reduced": [], "why": "test"})
    for cell in CELLS:
        model, _, traffic = cell.split(".")
        bench["workloads"].append({"name": cell, "config": f"{model}.tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        _dump(os.path.join(gb, "workloads", cell + ".json"),
              {"checked_steps": 3, "trace_seconds": 1, "limits": LIMITS,
               "gram_limits": GRAM_LIMITS})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [c for c in CELLS
                                               if c not in m["workloads"]]
    _dump(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest
