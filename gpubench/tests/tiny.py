"""A tiny copy of the benchmark for the CPU tests: the harness and two
cells of the benchmark's configurations at small widths over a seeded
graph of 60 nodes, in a temporary checkout, run through the harness's
CPU entry in a process of its own."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

GPUBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(GPUBENCH)
N_NODES = 60
WIDTHS = {"hid_dim": 12, "embed_dim": 8}
JOB = {"walk_time": 3, "walk_length": 3, "batch_size": 24, "neg_num": 4,
       "Q": 5}


def _write_data(root, seed=7):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "1.format"))
    os.makedirs(os.path.join(root, "nodes_set"))
    names = [f"U{i:05d}" for i in range(N_NODES)]
    with open(os.path.join(root, "nodes_set", "nodes.csv"), "w") as fp:
        fp.write("".join(n + "\n" for n in names))
    for t in range(5):
        core = rng.choice(N_NODES, 12, replace=False)
        edges = {(int(a), int(b)) for a in core for b in core
                 if a < b and rng.random() < 0.6}
        for _ in range(40):
            a, b = rng.choice(N_NODES, 2, replace=False)
            edges.add((int(min(a, b)), int(max(a, b))))
        with open(os.path.join(root, "1.format", f"{t:03d}.csv"), "w") as fp:
            fp.write("from_id\tto_id\tweight\n")
            fp.write("".join(f"{names[a]}\t{names[b]}\t1\n"
                             for a, b in sorted(edges)))
    lines = []
    for rel in sorted(f"1.format/{f}" for f in os.listdir(
            os.path.join(root, "1.format"))) + ["nodes_set/nodes.csv"]:
        with open(os.path.join(root, rel), "rb") as fp:
            lines.append(f"{hashlib.sha256(fp.read()).hexdigest()}  {rel}\n")
    with open(os.path.join(root, "SHA256SUMS"), "w") as fp:
        fp.writelines(lines)


def make_checkout(dest, limits=None):
    """A checkout at ``dest`` holding the program (a link to the repo's
    package), a copy of ``gpubench`` and a ``BENCHMARK.json`` of two tiny
    cells, ``ctgcn_c.tiny.uneg`` and ``gcrn.tiny.uneg``."""
    gb = os.path.join(dest, "gpubench")
    shutil.copytree(GPUBENCH, gb, ignore=shutil.ignore_patterns(
        "enron_w0", "__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "ctgcn_torch"),
               os.path.join(dest, "ctgcn_torch"))
    _write_data(os.path.join(gb, "data", "tiny"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    with open(os.path.join(gb, "traffic", "uneg.json")) as fp:
        traffic = json.load(fp)
    traffic["program"].update(JOB)
    with open(os.path.join(gb, "traffic", "uneg.json"), "w") as fp:
        json.dump(traffic, fp)
    configs, cells = [], []
    for model in ("ctgcn_c", "gcrn"):
        with open(os.path.join(GPUBENCH, "configs", f"{model}.enron.json")) \
                as fp:
            cfg = json.load(fp)
        cfg.update(WIDTHS, name=f"{model}.tiny", data="tiny")
        if model == "ctgcn_c":
            cfg["core_backend"] = "ell"
        path = f"gpubench/configs/{model}.tiny.json"
        with open(os.path.join(dest, path), "w") as fp:
            json.dump(cfg, fp)
        configs.append({"name": f"{model}.tiny", "source": "tiny",
                        "file": path, "reduced": [], "why": "test"})
        cell = f"{model}.tiny.uneg"
        cells.append({"name": cell, "config": f"{model}.tiny",
                      "traffic": "uneg", "chips": 1, "why": "test"})
        with open(os.path.join(gb, "workloads", cell + ".json"), "w") as fp:
            json.dump({"checked_steps": 3, "trace_seconds": 1,
                       "limits": limits or {"loss_gap": 1e-4,
                                            "grad_gap": 1e-4,
                                            "step_gap": 1e-3,
                                            "embed_gap": 1e-4}}, fp)
    bench["configs"], bench["workloads"] = configs, cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c["name"] for c in cells]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)
    return dest


def run_cpu(checkout, cell, seed, fault=None, control=False, tmp=None):
    """The harness's CPU entry in a process of its own: the parsed
    result."""
    code = ("import sys, json; sys.path.insert(0, 'gpubench');"
            "import harness;"
            f"print(json.dumps(harness.run_cpu({cell!r}, {seed}, "
            f"fault_name={fault!r}, control_run={control!r})))")
    env = dict(os.environ, PYTHONPATH=checkout, OMP_NUM_THREADS="2")
    if tmp:
        env["TMPDIR"] = tmp
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])
