"""Set-up, the checked steps, the window and the verdict of both tiny
cells on the CPU, through the harness's test-only entry; and the command
itself, which refuses to run without a card."""
import json
import os
import subprocess
import sys

import pytest

import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("co") / "co"))


@pytest.mark.parametrize("cell", ["ctgcn_c.tiny.uneg", "gcrn.tiny.uneg"])
def test_tiny_cell_is_correct(checkout, cell, tmp_path):
    out = tiny.run_cpu(checkout, cell, 2**31 + 11, tmp=str(tmp_path))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"epoch_ms", "peak_mem_gb", "setup_s"}
    assert out["epochs"] >= 1
    exact = [k for k, (v, lim) in out["checks"].items() if lim == 0]
    assert "walk_mismatch" in exact and "draw_faults" in exact
    assert out["modules"] == []


def test_command_refuses_without_a_card(checkout):
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "gcrn.tiny.uneg", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=checkout, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and gpubench/ gives no
    result."""
    import shutil
    shutil.copytree(tiny.GPUBENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, 'gpubench');"
                        "import harness, json;"
                        "print(json.dumps(harness.run_cpu("
                        "'gcrn.enron.uneg', 1)))"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert not r.stdout.strip().startswith("{")
    with open(tmp_path / "BENCHMARK.json") as fp:
        assert json.load(fp)["paths"] == ["gpubench"]
