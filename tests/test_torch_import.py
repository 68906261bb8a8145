# coding: utf-8
"""The PyTorch port stands alone: importing it pulls in no JAX and nothing
of ``ctgcn_tpu``, and no file of the port (or ``chip_smoke.py``) names a
JAX-side package, or a package the GPU machine does not have, in an
import."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ctgcn_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ctgcn_tpu",
             "pandas", "sklearn", "networkx")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ctgcn_torch\n"
        "for m in pkgutil.walk_packages(ctgcn_torch.__path__, "
        "'ctgcn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('ctgcn_torch.')]))\n"
        "assert not bad, bad\n"
        "assert 'ctgcn_torch.ops.ell' in sys.modules\n"
        "assert 'ctgcn_torch.evaluation.similarity_prediction' in "
        "sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every submodule was imported (walk_packages found them all)
    assert int(proc.stdout.strip().splitlines()[-1]) >= 35


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


def test_kernels_are_not_built_at_import():
    """Importing the port compiles nothing: the kernel library is loaded
    only when a CUDA tensor reaches a kernel wrapper."""
    from ctgcn_torch.ops import cuda_build

    assert cuda_build.load_kernels.cache_info().currsize == 0
