# coding: utf-8
"""Build the host-graph kernels (``hostgraph.cpp``) with ``g++ -O3
-fopenmp`` into a shared library with a plain C interface.

The build happens at first use (never at import), into
``ctgcn_torch/_build/`` (listed in ``.gitignore``).  The library's file
name carries a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The library is written
to a temporary file and renamed into place, so processes that build it at
once do not see each other's half-written file.  A failed build raises.

    python -m ctgcn_torch.native.build
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "hostgraph.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no -march=native: the library may be loaded on another host than the one
# that built it
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-funroll-loops")


def lib_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libhostgraph_{h.hexdigest()[:16]}.so"


def build(compiler="g++"):
    """The library's path, compiling the source first if the library is
    missing.  Raises ``RuntimeError`` when the compiler fails or is not
    found."""
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([compiler, *CXX_FLAGS, str(SRC), "-o", tmp],
                                  capture_output=True, text=True, check=False)
        except OSError as exc:
            raise RuntimeError(f"cannot run {compiler} to build the host-graph"
                               f" kernels: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed ({proc.returncode}) on "
                               f"{SRC.name}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


if __name__ == "__main__":
    print(build())
