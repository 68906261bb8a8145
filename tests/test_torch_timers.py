# coding: utf-8
"""TIMERS (``ctgcn_torch/nn/timers.py``) against ``ctgcn_tpu`` on the CPU.

ARPACK is pinned to start from the ones vector on both sides: the port
does so itself, and the JAX package's ``svds``/``eigs`` are wrapped here
(in the test only), as ``tests/test_torch_centrality.py`` pins
``eigsh``.  On a small evolving graph series, once with a rerun and once
without, the loss and bound sequences (which the JAX package prints) are
equal within 1e-9 relative, the rerun steps the same, and the embedding
CSVs byte-equal to the JAX package's pandas files; the float64 CSV rows
byte-equal to ``pandas.DataFrame.to_csv``'s; the helpers equal the JAX
ones, ``refine_bound``'s fallback when ``eigs`` cannot run included; and
the CLI writes one CSV a snapshot with every node.
"""
import functools
import json
import re
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from ctgcn_torch import main as cli
from ctgcn_torch.data import formats as TF
from ctgcn_torch.nn import timers as TT
from ctgcn_tpu.nn import timers as JT

ROOT = Path(__file__).resolve().parent.parent
N, T, DIM = 60, 5, 4
NAMES = list(range(100, 100 + N))
LINE = re.compile(r"time = (\d+), loss = (\S+), loss_bound = (\S+)")


def _write_series(base, seed=0):
    """T snapshots of a graph that grows and rewires: edges of weight 1-3
    kept with probability 0.8 and new ones added each step."""
    rng = np.random.default_rng(seed)
    (base / "nodes_set").mkdir(parents=True)
    (base / "nodes_set" / "nodes.csv").write_text(
        "".join(f"{n}\n" for n in NAMES))
    (base / "1.format").mkdir()
    edges = {}
    for t in range(T):
        edges = {e: w for e, w in edges.items() if rng.random() < 0.8}
        for _ in range(70):
            a, b = rng.integers(0, N, 2)
            if a != b:
                edges[(min(a, b), max(a, b))] = int(rng.integers(1, 4))
        (base / "1.format" / f"{t:03d}.csv").write_text(
            "from_id\tto_id\tweight\n" + "".join(
                f"{NAMES[a]}\t{NAMES[b]}\t{w}\n"
                for (a, b), w in sorted(edges.items())))
    return base


def _pinned(fn, v0_size):
    @functools.wraps(fn)
    def call(A, k, *args, **kw):
        kw.setdefault("v0", np.ones(v0_size(A.shape)))
        return fn(A, k, *args, **kw)
    return call


@pytest.fixture
def pinned_jax(monkeypatch):
    monkeypatch.setattr(JT, "svds", _pinned(JT.svds, min))
    monkeypatch.setattr(JT, "eigs", _pinned(JT.eigs, lambda s: s[0]))


@pytest.mark.parametrize("theta, reruns", [(0.0, True), (1e6, False)],
                         ids=["rerun", "no-rerun"])
def test_timers_equals_jax(tmp_path, capsys, pinned_jax, theta, reruns):
    base = _write_series(tmp_path / "data")
    paths = (str(base / "nodes_set" / "nodes.csv"), str(base / "1.format"))
    JT.timers(*paths, str(base / "jax"), Theta=theta, dim=DIM)
    printed = capsys.readouterr().out
    jax_rows = [(float(l), float(b)) for _, l, b in LINE.findall(printed)]
    jax_reruns = [int(i) for i in re.findall(r"Begin rerun at time stamp: "
                                             r"(\d+)", printed)]
    out = TT.timers(*paths, str(base / "torch"), Theta=theta, dim=DIM)
    assert len(out) == len(jax_rows) == T
    for r, (loss, bound) in zip(out, jax_rows):
        assert r["loss"] == pytest.approx(loss, rel=1e-9)
        assert r["bound"] == pytest.approx(bound, rel=1e-9)
    assert [i + 1 for i, r in enumerate(out) if r["rerun"]] == jax_reruns
    assert bool(jax_reruns) == reruns
    for t in range(T):
        name = f"{t:03d}.csv"
        got = (base / "torch" / name).read_bytes()
        assert got == (base / "jax" / name).read_bytes(), name
        assert got.startswith(b"\t0\t1\t2\t3\t4\t5\t6\t7\n100\t")


def test_float64_rows_equal_pandas():
    """``format_embedding_rows`` at float64 writes what pandas writes for
    a float64 frame (shortest repr, e.g. ``0.1``, ``1e-05``, ``-0.0``)."""
    vals = np.array([[0.1, 1e-05, -0.0, 1 / 3],
                     [123456789.12345679, -2.5e-300, 1e16, 7.0]])
    names = ["a", "b"]
    want = pd.DataFrame(vals, index=names, columns=range(4)).to_csv(sep="\t")
    got = TF._header(4, "\t") + TF.format_embedding_rows(
        vals, names, dtype=np.float64)
    assert got == want
    # the default stays float32's shortest repr
    assert TF.format_embedding_rows(vals[:1], ["a"]).split("\t")[1] == "0.1"


def test_helpers_equal_jax():
    """``frobenius_obj``, ``trip`` and ``refine_bound`` on the same inputs
    give the JAX functions' values; ``refine_bound`` falls back to no eigen
    part where ``eigs`` cannot run (a 2 x 2 matrix asks for 0 values)."""
    rng = np.random.default_rng(1)
    a = sp.random(30, 30, density=0.2, random_state=2)
    a = (a + a.T).tocsr()
    d = sp.random(30, 30, density=0.05, random_state=3)
    d = (d + d.T).tocsr()
    U = rng.standard_normal((30, 4))
    V = rng.standard_normal((30, 4))
    assert TT.frobenius_obj(a, U, V) == JT.frobenius_obj(a, U, V)
    u, s, vt = TT._svds(a, 4)
    for got, want in zip(TT.trip(u, np.diag(s), vt.T, d),
                         JT.trip(u, np.diag(s), vt.T, d)):
        np.testing.assert_array_equal(got, want)
    small = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]]))
    got = TT.refine_bound(small, small * 0.5, 2.0, 3)
    assert got == JT.refine_bound(small, small * 0.5, 2.0, 3)
    assert got == 2.0 + (1.5 ** 2 - 1.0) * 2


def test_cli_runs_timers(tmp_path):
    """``--task=embedding --method=TIMERS --device cpu`` on the config's
    entry (``embed_dim`` 8, so 4 singular vectors a side): one float64 CSV
    a snapshot holding every node, the recorded times."""
    base = _write_series(tmp_path / "data")
    with open(ROOT / "configs" / "uci.json") as fp:
        emb = json.load(fp)["embedding"]["TIMERS"]
    emb = dict(emb, base_path=str(base), embed_dim=2 * DIM)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"embedding": {"TIMERS": emb}}))
    out = cli.main([f"--config={path}", "--task=embedding",
                    "--method=TIMERS", "--device=cpu"])
    assert [r["file"] for r in out] == [f"{t:03d}.csv" for t in range(T)]
    assert not out[0]["rerun"]
    for t in range(T):
        names, arr = TF.read_embedding_csv(
            base / emb["embed_folder"] / f"{t:03d}.csv", dtype=np.float64)
        assert names == NAMES and arr.shape == (N, 2 * DIM)
        assert np.isfinite(arr).all()
    times = (base / "TIMERS_time.csv").read_text().splitlines()
    assert times[0] == "time" and len(times) == T + 1
