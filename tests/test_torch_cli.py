# coding: utf-8
"""``python -m ctgcn_torch.main`` end to end on the CPU: the preprocessing
and embedding tasks of CTGCN-C (U-neg, BSR backend, and the default
``"auto"`` backend, at each ``matmul_precision``), CGCN-C, CGCN-S and
CTGCN-S on a small generated dataset, one epoch, and the supervised
learning types, two epochs.  The embedding and time
CSVs must read the way the JAX package's evaluators read them (pandas,
tab-separated, node name as the index)."""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from ctgcn_torch import main as cli
from ctgcn_torch.training import driver
from ctgcn_torch.training.engine import read_model_file

ROOT = Path(__file__).resolve().parent.parent
N, SNAPS = 120, 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Four snapshots of a small weighted graph and a config taken from
    configs/uci.json (CTGCN-C), narrowed to test size."""
    base = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    names = [f"u{i}" for i in range(N)]
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text("\n".join(names) + "\n")
    (base / "1.format").mkdir()
    for t in range(SNAPS):
        src = rng.integers(0, N, 500)
        dst = rng.integers(0, N // (t + 1) + 8, 500) % N
        (base / "1.format" / f"2010-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"u{a}\tu{b}\t{rng.integers(1, 5)}\n"
                for a, b in zip(src, dst)))
    with open(ROOT / "configs" / "uci.json") as fp:
        uci = json.load(fp)
    pre = dict(uci["preprocessing"]["CTGCN-C"], base_path=str(base),
               walk_time=3)
    emb = dict(uci["embedding"]["CTGCN-C"], base_path=str(base),
               core_backend="pallas", epoch=1, duration=3, hid_dim=12,
               embed_dim=6, batch_size=50, neg_num=4)
    cfg = base / "cfg.json"
    cfg.write_text(json.dumps({"preprocessing": {"CTGCN-C": pre},
                               "embedding": {"CTGCN-C": emb}}))
    return base, cfg, names, emb


@pytest.fixture(scope="module")
def trained(dataset):
    base, cfg, names, emb = dataset
    proc = subprocess.run(
        [sys.executable, "-m", "ctgcn_torch.main", f"--config={cfg}",
         "--task=preprocessing", "--method=CTGCN-C", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    results = cli.main([f"--config={cfg}", "--task=embedding",
                        "--method=CTGCN-C", "--device=cpu"])
    return results


def test_preprocessing_writes_the_artifact_tree(dataset, trained):
    base, _, _, emb = dataset
    for folder in (emb["core_folder"], emb["walk_pair_folder"],
                   emb["node_freq_folder"]):
        assert len(os.listdir(base / folder)) == SNAPS


def test_embedding_windows_and_losses(trained):
    # duration 3 over 4 snapshots: windows at 0 and 3
    assert [r["idx"] for r in trained] == [0, 3]
    for r in trained:
        assert len(r["losses"]) == 1 and np.isfinite(r["losses"]).all()


def test_embedding_csvs_read_like_the_jax_evaluators(dataset, trained):
    base, _, names, emb = dataset
    out = base / emb["embed_folder"]
    files = sorted(os.listdir(out))
    assert files == [f"2010-0{t + 1}.csv" for t in range(SNAPS)]
    for f in files:
        df = pd.read_csv(out / f, sep="\t", index_col=0)
        assert list(df.columns) == [str(j) for j in range(emb["embed_dim"])]
        arr = df.loc[names, :].values
        assert arr.shape == (N, emb["embed_dim"])
        assert np.isfinite(arr).all()


def test_time_csv_and_model_file(dataset, trained):
    base, _, _, emb = dataset
    times = pd.read_csv(base / "CTGCN-C_time.csv")
    assert list(times.columns) == ["time"] and len(times) == 2
    state = read_model_file(base / emb["model_folder"] / emb["model_file"])
    assert state["norm.scale"].shape == (emb["embed_dim"],)


def test_default_device_without_gpu_raises(dataset):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    _, cfg, _, _ = dataset
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([f"--config={cfg}", "--task=embedding",
                  "--method=CTGCN-C"])


@pytest.mark.parametrize("change, error", [
    ({"remat_policy": "save_spmm"}, None),
    ({"n_devices": 2, "temporal_pipeline": True}, None),
    ({"matmul_precision": "fp8"}, ValueError),
    ({"profile_dir": "prof"}, None),
    ({"remat_policy": "none"}, ValueError),
])
def test_unported_options_raise(dataset, trained, tmp_path, change, error):
    """Every option of the JAX driver is ported: ``remat_policy:
    "save_spmm"`` reaches the trainer's model (and changes no loss under
    the activation budget), ``profile_dir`` writes one trace a window of
    epoch 0 (the config's one epoch); an unknown precision or policy
    raises.  ``temporal_pipeline`` with ``n_devices: 2`` passes
    ``_check_scope``, which no longer reads the world size
    (``tests/test_torch_pipeline.py`` runs it on 2 ranks)."""
    _, cfg, _, _ = dataset
    config = json.loads(Path(cfg).read_text())
    entry = config["embedding"]["CTGCN-C"]
    entry.update(change, embed_folder="2.embedding/options",
                 model_file="options", record_time=False)
    if "n_devices" in change:
        assert error is None
        driver._check_scope("CTGCN-C", entry)
        return
    if "profile_dir" in change:
        entry["profile_dir"] = str(tmp_path / "prof")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config))
    argv = [f"--config={path}", "--task=embedding", "--method=CTGCN-C",
            "--device=cpu"]
    if error is not None:
        with pytest.raises(error, match="matmul_precision|remat_policy"):
            cli.main(argv)
        return
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = cli.main(argv)
    assert [r["losses"] for r in results] == [r["losses"] for r in trained]
    model = results[-1]["trainer"].model
    assert model.remat_policy == change.get("remat_policy", "full")
    if "profile_dir" in change:
        traces = sorted((tmp_path / "prof").iterdir())
        assert len(traces) == len(results) == 2
        assert all(p.name.endswith(".pt.trace.json") for p in traces)
        assert out.getvalue().count("profiler trace written to "
                                    f"{tmp_path / 'prof'} (epochs 0..0)") \
            == 2


def test_n_devices_on_one_process_matches_single_device(dataset, trained,
                                                        tmp_path):
    """``n_devices: 2`` in one process runs on one part, as the JAX driver
    does on one device (with its notice): the same CSVs, byte for byte,
    as the run without the key."""
    base, cfg, _, _ = dataset
    config = json.loads(Path(cfg).read_text())
    entry = config["embedding"]["CTGCN-C"]
    outs = []
    for tag, change in (("one", {}), ("nd2", {"n_devices": 2})):
        config["embedding"]["CTGCN-C"] = dict(
            entry, embed_folder=f"2.embedding/{tag}", model_file=tag,
            record_time=False, **change)
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps(config))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = cli.main([f"--config={path}", "--task=embedding",
                            "--method=CTGCN-C", "--device=cpu"])
        assert [r["parts"] for r in res] == [1, 1]
        outs.append((base / "2.embedding" / tag, log.getvalue()))
    (one, _), (nd2, log) = outs
    assert "n_devices: no divisor of T=3 in range" in log
    files = sorted(os.listdir(one))
    assert files == sorted(os.listdir(nd2)) and len(files) == SNAPS
    for f in files:
        assert (one / f).read_bytes() == (nd2 / f).read_bytes(), f


@pytest.mark.parametrize("method, change, backend", [
    ("CTGCN-C", {"matmul_precision": "bf16"}, "blocks"),
    ("CTGCN-C", {"matmul_precision": "bf16", "core_backend": "ell"}, "ell"),
    ("CTGCN-C", {"matmul_precision": "high"}, "blocks"),
    ("CTGCN-S", {}, "blocks"),
    ("CGCN-C", {}, "blocks"),
    ("CGCN-S", {}, "blocks"),
], ids=["bf16", "bf16_ell", "high", "CTGCN-S", "CGCN-C", "CGCN-S"])
def test_precisions_and_methods_run(dataset, trained, tmp_path, method,
                                    change, backend):
    """``matmul_precision`` "bf16" and "high", and CGCN-C, CGCN-S and
    CTGCN-S (U-own, degree features) as ``configs/uci.json`` gives them,
    narrowed to test size, one epoch: finite losses and one embedding CSV
    per snapshot, every node at ``embed_dim`` (the S-variants export the
    structure embedding, which has that width too)."""
    base, _, names, emb = dataset
    with open(ROOT / "configs" / "uci.json") as fp:
        entry = dict(json.load(fp)["embedding"][method])
    entry.update(base_path=str(base), epoch=1, hid_dim=12, embed_dim=6,
                 batch_size=50, neg_num=4, record_time=False,
                 duration=min(entry["duration"], 3),
                 embed_folder=f"2.embedding/{tmp_path.name}",
                 model_file=tmp_path.name, **change)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {method: entry}}))
    results = cli.main([f"--config={path}", "--task=embedding",
                        f"--method={method}", "--device=cpu"])
    windows = -(-SNAPS // entry["duration"])
    assert [r["core_backend"] for r in results] == [backend] * windows
    assert all(len(r["losses"]) == 1 and np.isfinite(r["losses"]).all()
               for r in results)
    out = base / entry["embed_folder"]
    files = sorted(os.listdir(out))
    assert files == [f"2010-0{t + 1}.csv" for t in range(SNAPS)]
    for f in files:
        arr = pd.read_csv(out / f, sep="\t", index_col=0).loc[names].values
        assert arr.shape == (N, 6) and np.isfinite(arr).all()


@pytest.mark.parametrize("method, lt", [
    ("CTGCN-C", "S-node"), ("CTGCN-C", "S-edge"), ("CTGCN-S", "S-link-st"),
    ("CTGCN-C", "S-link-dy")])
def test_supervised_types_run(dataset, trained, tmp_path, method, lt):
    """The supervised learning types as ``configs/america-air.json`` gives
    their keys, with ``learning_type`` changed, narrowed to test size, two
    epochs: finite losses, test accuracy and AUC in [0, 1], the model and
    (S-node, S-edge) classifier files, and one embedding CSV per
    snapshot.  S-link-dy (duration 4 here) skips the last snapshot, which
    only gives edges to predict, so its one window holds 3 snapshots."""
    base, _, names, emb = dataset
    rng = np.random.default_rng(1)
    for folder, cols in (("nodes_label", 1), ("edges_label", 2)):
        (base / folder).mkdir(exist_ok=True)
        for t in range(SNAPS):
            rows = "".join(
                "\t".join([*(f"u{i}" for i in rng.integers(0, N, cols)),
                           str(rng.integers(0, 3))]) + "\n"
                for _ in range(N))
            (base / folder / f"{t}.csv").write_text(
                ("node\tlabel\n" if cols == 1 else
                 "from_id\tto_id\tlabel\n") + rows)
    with open(ROOT / "configs" / "america-air.json") as fp:
        entry = dict(json.load(fp)["embedding"][method])
    entry.update(base_path=str(base), learning_type=lt, epoch=2, hid_dim=12,
                 embed_dim=6, duration=4 if lt == "S-link-dy" else 3,
                 elabel_folder="edges_label",
                 core_folder=emb["core_folder"],
                 embed_folder=f"2.embedding/{tmp_path.name}",
                 model_file=f"{tmp_path.name}_m",
                 cls_file=f"{tmp_path.name}_c")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {method: entry}}))
    results = cli.main([f"--config={path}", "--task=embedding",
                        f"--method={method}", "--device=cpu"])
    assert [(r["idx"], r["time_length"]) for r in results] == (
        [(0, 3)] if lt == "S-link-dy" else [(0, 3), (3, 1)])
    for r in results:
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert 0.0 <= r["acc_test"] <= 1.0
        assert np.isnan(r["auc_test"]) or 0.0 <= r["auc_test"] <= 1.0
    model_dir = base / entry["model_folder"]
    assert (model_dir / entry["model_file"]).exists()
    assert (model_dir / entry["cls_file"]).exists() == (
        lt in ("S-node", "S-edge"))
    files = sorted(os.listdir(base / entry["embed_folder"]))
    exported = SNAPS - (lt == "S-link-dy")
    assert files == [f"2010-0{t + 1}.csv" for t in range(exported)]
    for f in files:
        arr = pd.read_csv(base / entry["embed_folder"] / f, sep="\t",
                          index_col=0).loc[names].values
        assert arr.shape == (N, 6) and np.isfinite(arr).all()


def test_embedding_without_core_backend_runs_auto(dataset, trained,
                                                  tmp_path):
    """A config with no ``core_backend`` key runs the JAX default,
    ``"auto"``, which picks the principal blocks on this small graph."""
    base, cfg, names, emb = dataset
    config = json.loads(Path(cfg).read_text())
    entry = config["embedding"]["CTGCN-C"]
    del entry["core_backend"]
    entry.update(embed_folder="2.embedding/auto", model_file="auto",
                 record_time=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config))
    results = cli.main([f"--config={path}", "--task=embedding",
                        "--method=CTGCN-C", "--device=cpu"])
    assert [r["core_backend"] for r in results] == ["blocks", "blocks"]
    assert all(np.isfinite(r["losses"]).all() for r in results)
    files = sorted(os.listdir(base / "2.embedding" / "auto"))
    assert files == [f"2010-0{t + 1}.csv" for t in range(SNAPS)]


@pytest.mark.parametrize("task, method", [("link_pred", None),
                                          ("embedding", "CTGCN-S")])
def test_unported_tasks_and_methods_raise(dataset, tmp_path, task, method):
    """Every task and every method is ported: ``link_pred`` runs its
    section, and an empty one stops at the first key it needs; a
    supervised learning type with ``n_devices: 2`` passes ``_check_scope``,
    which no longer reads the world size
    (``tests/test_torch_supervised_dist.py`` runs the supervised types on
    2 ranks)."""
    _, cfg, _, _ = dataset
    config = json.loads(Path(cfg).read_text())
    config["link_pred"] = {}
    config["embedding"]["CTGCN-S"] = dict(config["embedding"]["CTGCN-C"],
                                          n_devices=2,
                                          learning_type="S-node")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config))
    argv = [f"--config={path}", f"--task={task}", "--device=cpu"]
    if method:
        argv.append(f"--method={method}")
    if task == "link_pred":
        with pytest.raises(KeyError, match="base_path"):
            cli.main(argv)
        return
    driver._check_scope(method, config["embedding"][method])
