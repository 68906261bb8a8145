# coding: utf-8
"""Build the CUDA sources in ``ctgcn_torch/csrc/`` with ``nvcc`` into a
shared library with a plain C interface, and load it with ``ctypes``.

The build happens at first use (never at import), for ``sm_90a``, into
``ctgcn_torch/_build/`` (listed in ``.gitignore``).  The library's file
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bsr_spmm.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (restype is int = cudaGetLastError())
_SIGNATURES = {
    # (csr_row, csr_col, csr_val, walk_nz, walk_warp, n_cta, walk_rows,
    #  empty_runs, n_runs, x, out, n_rows, d, stream)
    "bsr_spmm_rowwalk": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _I, _I,
                         _P),
    # (csr_ptr, csr_row, csr_col, csr_val, cross_rows, n_cross, empty_runs,
    #  n_runs, x, scratch, out, n_rows, nnz, chunk, regs, d, stream)
    "bsr_spmm_blockpar": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I,
                          _I, _I, _I, _I, _P),
    # the same with x in bf16, then out_f32 (0: bf16 out) before the stream
    "bsr_spmm_rowwalk_bf16": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                              _I, _I, _I, _P),
    "bsr_spmm_blockpar_bf16": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P),
    # (d, bf16, by_row, int32[6] out): the kernels' launch geometry
    "bsr_spmm_geometry": (_I, _I, _I, _P),
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built from source at first use")


def _lib_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libctgcn_kernels_{h.hexdigest()[:16]}.so"


def build_kernels():
    """Compile the sources if their library is missing.

    Returns (library path, build seconds, nvcc's output -- ptxas register,
    spill and shared-memory report).  The report is kept beside the
    library and read back when the library is already there."""
    path = _lib_path()
    report = path.with_suffix(".log")
    if path.exists() and report.exists():
        return path, 0.0, report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             *[str(SRC_DIR / s) for s in SOURCES]],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.time() - t0, proc.stdout + proc.stderr


@functools.cache
def load_kernels():
    """The loaded kernel library (built on first call), with ``argtypes``
    and ``restype`` declared for every entry point."""
    path, _, _ = build_kernels()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
