"""A later cell, traffic mix, training job and per-layer metric are new
files and new entries of BENCHMARK.json alone: no file of the harness
changes."""
import hashlib
import json
import os

import tiny

#: a job that changes the engine call (node batches in order) and takes
#: everything else from U-neg; it logs each call of its own ``learn``
ORDERED_JOB = '''"""U-neg over node batches in order."""
import os

from jobs import uneg


def __getattr__(name):
    return getattr(uneg, name)


def learn(trainer, args, epochs, seed):
    with open(os.path.join(os.environ["TMPDIR"], "ordered_calls"), "a") as fp:
        fp.write(f"{epochs}\\n")
    return trainer.learn_embedding(
        epoch=epochs, batch_size=args["batch_size"], lr=args["lr"],
        weight_decay=args["weight_decay"], model_file=None, export=False,
        shuffle=False, seed=int(seed), verbose=False)
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "gpubench")):
        for f in files:
            if "__pycache__" in d:
                continue
            with open(os.path.join(d, f), "rb") as fp:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fp.read()).hexdigest()
    return out


def test_new_cell_and_metric_from_files_alone(tmp_path):
    co = tiny.make_checkout(str(tmp_path / "co"))
    before = _digests(co)
    gb = os.path.join(co, "gpubench")
    with open(os.path.join(gb, "traffic", "uneg.json")) as fp:
        traffic = json.load(fp)
    traffic["program"]["batch_size"] = 16
    traffic["job"] = "uneg_ordered"
    with open(os.path.join(gb, "traffic", "uneg_b16.json"), "w") as fp:
        json.dump(traffic, fp)
    with open(os.path.join(gb, "jobs", "uneg_ordered.py"), "w") as fp:
        fp.write(ORDERED_JOB)
    with open(os.path.join(gb, "workloads", "gcrn.tiny.uneg.json")) as fp:
        spec = json.load(fp)
    with open(os.path.join(gb, "workloads", "gcrn.tiny.uneg_b16.json"),
              "w") as fp:
        json.dump(spec, fp)
    with open(os.path.join(gb, "metrics", "epochs_run.py"), "w") as fp:
        fp.write("def read(ctx):\n    return float(ctx['epochs'])\n")
    with open(os.path.join(co, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["workloads"].append({"name": "gcrn.tiny.uneg_b16",
                               "config": "gcrn.tiny", "traffic": "uneg_b16",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "epochs_run", "unit": "epochs",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "epoch_ms",
                               "workloads": ["gcrn.tiny.uneg_b16"]})
    with open(os.path.join(co, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)
    after = _digests(co)
    assert all(after[k] == v for k, v in before.items())
    out = tiny.run_cpu(co, "gcrn.tiny.uneg_b16", 17, tmp=str(tmp_path))
    assert out["correct"], out["checks"]
    # the checked steps, the timing epoch and the window, all by the job
    with open(tmp_path / "ordered_calls") as fp:
        calls = [int(x) for x in fp.read().split()]
    assert calls[:2] == [3, 1] and len(calls) == 3
    code = ("import sys, json; sys.path.insert(0, 'gpubench');"
            "import harness;"
            "c = harness.Cell('gcrn.tiny.uneg_b16');"
            "print(json.dumps([m['name'] for m in c.per_layer]))")
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", code], cwd=co,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=co))
    assert "epochs_run" in json.loads(r.stdout.strip().splitlines()[-1])
