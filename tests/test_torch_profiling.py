# coding: utf-8
"""``ctgcn_torch.training.profiling`` against ``ctgcn_tpu``'s
``EpochTracer``, and the driver's diagnostics, on the CPU:

  * the epoch window: for 0-6 epochs the port's tracer starts and stops at
    the epochs where the JAX tracer calls ``jax.profiler.start_trace`` and
    ``stop_trace`` (monkeypatched to record the calls);
  * a 3-epoch CLI run with ``profile_dir`` writes one Chrome trace a
    window covering epochs 1-2 (its "epoch" ranges), under U-neg and
    S-link-st, and a 1-epoch run writes one of epoch 0; a loop that ends
    early is closed by ``close``; ``CTGCN_TPU_PROFILE_DIR`` stands in for
    the key;
  * ``CTGCN_TPU_PHASE_TIMES`` prints the ``[phase]`` lines and
    ``CTGCN_TPU_MEM_REPORT`` the CPU's note, read once a run.
"""
import contextlib
import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from ctgcn_torch import main as cli
from ctgcn_torch.training.profiling import EpochTracer
from ctgcn_tpu.training import profiling as jprofiling

ROOT = Path(__file__).resolve().parent.parent
N, SNAPS = 60, 3


def _window(tracer, n, stop_early=None):
    """(start epoch, stop epoch) of ``tracer`` over an ``n``-epoch loop
    (None where it never starts or stops); ``stop_early``: the epoch
    after which the loop breaks before ``close``."""
    start = stop = None
    for i in range(n):
        was = tracer.active
        tracer.before_epoch(i)
        if tracer.active and not was:
            start = i
        with tracer.annotate(i):
            pass
        was = tracer.active
        tracer.after_epoch(i)
        if was and not tracer.active:
            stop = i
        if i == stop_early:
            break
    was = tracer.active
    tracer.close()
    if was and not tracer.active:
        stop = "close"
    return start, stop


@pytest.mark.parametrize("n", range(7))
def test_epoch_window_equals_jax(monkeypatch, tmp_path, n):
    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: calls.append(("start", d)))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: calls.append(("stop",)))
    jtracer = jprofiling.EpochTracer(str(tmp_path / "jax"), n)
    jwin = _window(jtracer, n)
    assert [c[0] for c in calls] == (["start", "stop"] if n else [])
    tracer = EpochTracer(str(tmp_path / "torch"), n)
    assert (tracer.first, tracer.last) == (jtracer.first, jtracer.last)
    assert _window(tracer, n) == jwin
    if n:
        assert jwin == (min(1, n - 1), min(3, n - 1))
        traces = list((tmp_path / "torch").iterdir())
        assert traces == [Path(tracer.path)]
        assert _epoch_ranges(tracer.path) == jwin[1] - jwin[0] + 1
    else:
        assert not (tmp_path / "torch").exists()


def test_close_stops_a_loop_that_ends_early(monkeypatch, tmp_path):
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    jwin = _window(jprofiling.EpochTracer(str(tmp_path / "j"), 6), 6, 1)
    tracer = EpochTracer(str(tmp_path / "t"), 6)
    assert _window(tracer, 6, stop_early=1) == jwin == (1, "close")
    assert _epoch_ranges(tracer.path) == 1


def test_no_directory_traces_nothing(monkeypatch):
    monkeypatch.delenv("CTGCN_TPU_PROFILE_DIR", raising=False)
    tracer = EpochTracer(None, 4)
    assert _window(tracer, 4) == (None, None) and tracer.path is None


def _epoch_ranges(path):
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    return sum(1 for e in events if e.get("name") == "epoch"
               and e.get("cat") == "user_annotation")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three snapshots of a small weighted graph, preprocessed by the
    port's CLI, and configs/uci.json's CTGCN-C entry narrowed to test
    size (one window)."""
    base = tmp_path_factory.mktemp("prof")
    rng = np.random.default_rng(0)
    (base / "nodes_set").mkdir()
    (base / "nodes_set" / "nodes.csv").write_text(
        "\n".join(f"u{i}" for i in range(N)) + "\n")
    (base / "1.format").mkdir()
    for t in range(SNAPS):
        src, dst = rng.integers(0, N, 240), rng.integers(0, N, 240)
        (base / "1.format" / f"2010-0{t + 1}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"u{a}\tu{b}\t{rng.integers(1, 5)}\n"
                for a, b in zip(src, dst)))
    with open(ROOT / "configs" / "uci.json") as fp:
        uci = json.load(fp)
    pre = dict(uci["preprocessing"]["CTGCN-C"], base_path=str(base),
               walk_time=2)
    emb = dict(uci["embedding"]["CTGCN-C"], base_path=str(base),
               duration=SNAPS, hid_dim=8, embed_dim=4, batch_size=30,
               neg_num=3, record_time=False)
    cfg = base / "cfg.json"
    cfg.write_text(json.dumps({"preprocessing": {"CTGCN-C": pre}}))
    cli.main([f"--config={cfg}", "--task=preprocessing", "--method=CTGCN-C",
              "--device=cpu"])
    return base, emb


def _run(dataset, tmp_path, **change):
    """The CLI's embedding task on the narrowed entry with ``change``:
    (its results, what it printed)."""
    _, emb = dataset
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {"CTGCN-C": dict(
        emb, embed_folder="2.embedding/prof", model_file="prof",
        **change)}}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = cli.main([f"--config={path}", "--task=embedding",
                            "--method=CTGCN-C", "--device=cpu"])
    return results, out.getvalue()


@pytest.mark.parametrize("epoch, learning_type, window", [
    (3, "U-neg", (1, 2)), (1, "U-neg", (0, 0)), (3, "S-link-st", (1, 2))])
def test_cli_run_writes_one_trace(dataset, tmp_path, epoch, learning_type,
                                  window):
    prof = tmp_path / "prof"
    results, printed = _run(dataset, tmp_path, epoch=epoch,
                            learning_type=learning_type,
                            profile_dir=str(prof))
    assert len(results) == 1 and len(results[0]["losses"]) == epoch
    traces = sorted(prof.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    assert printed.count(f"profiler trace written to {prof} "
                         f"(epochs {window[0]}..{window[1]})") == 1
    assert _epoch_ranges(traces[0]) == window[1] - window[0] + 1


def test_profile_dir_variable_and_diagnostics(dataset, tmp_path,
                                              monkeypatch):
    """No config key: ``CTGCN_TPU_PROFILE_DIR`` names the directory;
    ``CTGCN_TPU_PHASE_TIMES`` and ``CTGCN_TPU_MEM_REPORT`` print their
    lines."""
    prof = tmp_path / "env-prof"
    monkeypatch.setenv("CTGCN_TPU_PROFILE_DIR", str(prof))
    monkeypatch.setenv("CTGCN_TPU_PHASE_TIMES", "1")
    monkeypatch.setenv("CTGCN_TPU_MEM_REPORT", "1")
    _, printed = _run(dataset, tmp_path, epoch=2)
    assert len(list(prof.iterdir())) == 1
    phases = re.findall(r"\[phase\] (\w+)", printed)
    assert phases == ["setup", "embed_fn", "save_embedding", "save_params",
                      "run_window"]
    assert re.search(r"\[phase\] run_window \(train [0-9.]+s incl\): "
                     r"[0-9.]+s", printed)
    assert "idx = 0: no allocator statistic on the CPU" in printed
    monkeypatch.delenv("CTGCN_TPU_PHASE_TIMES")
    monkeypatch.delenv("CTGCN_TPU_MEM_REPORT")
    _, printed = _run(dataset, tmp_path, epoch=1)
    assert "[phase]" not in printed and "allocator" not in printed
