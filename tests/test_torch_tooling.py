# coding: utf-8
"""``ctgcn_torch.data.tooling`` against ``ctgcn_tpu.data.tooling``: each
of the five functions writes the same files, byte for byte, from the same
inputs and the same ``RandomState`` seed.  The inputs are small synthetic
edge lists and label files built as ``tests/unit/test_tooling.py`` builds
them (integer ids, "U" names, unit and fractional weights), and
``format_uci`` also runs on the raw UCI input in the repository."""
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from ctgcn_torch.data import tooling as T
from ctgcn_tpu.data import tooling as J

ROOT = Path(__file__).resolve().parent.parent


def _tree(path):
    """{relative path: bytes} of every file under ``path``."""
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(Path(path).rglob("*")) if p.is_file()}


def _both(tmp_path, call):
    """``call(module, out_dir)`` for each package; the two trees."""
    trees = []
    for name, mod in (("jax", J), ("torch", T)):
        out = tmp_path / name
        out.mkdir()
        call(mod, out)
        trees.append(_tree(out))
    return trees


def _assert_same(trees, n_files):
    jax_tree, torch_tree = trees
    assert sorted(torch_tree) == sorted(jax_tree)
    assert len(jax_tree) == n_files
    for name, data in jax_tree.items():
        assert torch_tree[name] == data, name


@pytest.mark.parametrize("weights", ["none", "fractional"])
@pytest.mark.parametrize("graph_num", [5, 7])
def test_build_dynamic_graph_bytes(tmp_path, weights, graph_num):
    rng = np.random.RandomState(3)
    rows = [f"{i}\t{i + 1}" for i in range(100)]
    if weights == "fractional":
        rows = [f"{r}\t{round(w, d)}" for r, w, d in zip(
            rows, rng.rand(100) * 10, rng.randint(0, 6, 100))]
    src = tmp_path / "raw.csv"
    src.write_text("\n".join(rows) + "\n")
    trees = _both(tmp_path, lambda mod, out: mod.build_dynamic_graph(
        str(src), str(out / "fmt"), str(out / "nodes"), sep="\t",
        graph_num=graph_num, rng=np.random.RandomState(0)))
    _assert_same(trees, graph_num + 1)


@pytest.mark.parametrize("labels", ["node label\n1 0\n2 1\n",
                                    "node label\n10 a\n3 b\n7 a\n",
                                    "node label\n5 0.5\n6 1.25\n"])
def test_copy_node_labels_bytes(tmp_path, labels):
    lp = tmp_path / "labels.csv"
    lp.write_text(labels)
    trees = _both(tmp_path, lambda mod, out: mod.copy_node_labels(
        str(lp), str(out / "out"), graph_num=3))
    _assert_same(trees, 3)


def _edge_file(path, rng, n=50, m=200, weight=None):
    df = pd.DataFrame({
        "from_id": [f"U{rng.randint(n)}" for _ in range(m)],
        "to_id": [f"U{rng.randint(n)}" for _ in range(m)],
        "weight": rng.rand(m) if weight is None else weight,
    })
    df.to_csv(path, sep="\t", index=False)
    return df


@pytest.mark.parametrize("weight", [1.0, None], ids=["unit", "random"])
def test_get_graph_from_edges_bytes(tmp_path, rng, weight):
    src = tmp_path / "edges.csv"
    _edge_file(src, rng, weight=weight)
    trees = _both(tmp_path, lambda mod, out: mod.get_graph_from_edges(
        str(src), None, str(out / "n"), str(out / "e"),
        edge_num_list=(10, 50, 500), rng=np.random.RandomState(0)))
    _assert_same(trees, 6)


@pytest.mark.parametrize("weight", [1.0, None], ids=["unit", "random"])
def test_get_graph_from_nodes_bytes(tmp_path, rng, weight):
    src = tmp_path / "edges.csv"
    df = _edge_file(src, rng, n=60, m=240, weight=weight)
    names = sorted(set(df["from_id"]) | set(df["to_id"]))
    node_file = tmp_path / "nodes.csv"
    node_file.write_text("\n".join(names) + "\n")
    trees = _both(tmp_path, lambda mod, out: mod.get_graph_from_nodes(
        str(src), str(node_file), str(out / "n"), str(out / "e"),
        node_num_list=(5, 20, 40), rng=np.random.RandomState(1)))
    _assert_same(trees, 8)


def test_format_uci_synthetic_bytes(tmp_path):
    """Months out of order, a blank line, ids that sort differently as
    strings than as ints."""
    rng = np.random.RandomState(0)
    stamps = rng.randint(1_080_000_000, 1_100_000_000, 300)
    lines = ["% asym positive", "% 300 40 40"] + [
        f"{rng.randint(1, 40)} {rng.randint(1, 40)}  {rng.randint(1, 3)} {s}"
        for s in stamps]
    lines.insert(100, "")
    raw = tmp_path / "graph.txt"
    raw.write_text("\n".join(lines) + "\n")
    trees = _both(tmp_path, lambda mod, out: mod.format_uci(
        str(raw), str(out / "fmt"), str(out / "nodes")))
    months = {pd.Timestamp(int(s), unit="s").strftime("%Y-%m")
              for s in stamps}
    _assert_same(trees, len(months) + 1)


def test_format_uci_on_the_raw_uci_input(tmp_path):
    """The repository's raw UCI input: 7 monthly files (2004-04 to
    2004-10) and 1,899 nodes, the same bytes as the JAX function's."""
    raw = ROOT / "data" / "uci" / "0.input" / "graph.txt"
    trees = _both(tmp_path, lambda mod, out: mod.format_uci(
        str(raw), str(out / "fmt"), str(out / "nodes")))
    _assert_same(trees, 8)
    files = sorted(n for n in trees[1] if n.startswith("fmt"))
    assert files[0] == os.path.join("fmt", "2004-04.csv")
    assert files[-1] == os.path.join("fmt", "2004-10.csv")
    assert trees[1][os.path.join("nodes", "nodes.csv")].count(b"\n") == 1899
