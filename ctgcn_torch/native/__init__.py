# coding: utf-8
"""ctypes bindings of the host-graph kernels (``hostgraph.cpp``), the
port's own copy of the JAX package's: exact k-core numbers by a
bucket-queue peel, and weighted random walks with one splitmix64 stream a
walk.  Preprocessing runs them by default.

The library is built with g++ at first use (``build.py``).  A failed build
raises: there is no quiet fallback to the numpy sampler, whose walks
differ, so a run's artifact tree would depend on whether a compiler was
there.
"""
from __future__ import annotations

import ctypes
import functools
import multiprocessing
import os

import numpy as np


@functools.cache
def load():
    """The loaded library (built on first call), with ``argtypes`` and
    ``restype`` declared for both entry points."""
    from ctgcn_torch.native.build import build

    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hg_core_numbers.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.hg_core_numbers.restype = None
    lib.hg_simulate_walks.argtypes = [
        ctypes.c_int64, i64p, i32p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32, i32p]
    lib.hg_simulate_walks.restype = None
    return lib


def _csr_arrays(A):
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"square adjacency expected, got {A.shape}")
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    return indptr, indices


def core_numbers(A) -> np.ndarray:
    """Exact k-core numbers (int64) of a symmetric, self-loop-free scipy
    CSR; isolated nodes get 0."""
    indptr, indices = _csr_arrays(A)
    n = A.shape[0]
    core = np.zeros(n, dtype=np.int64)
    load().hg_core_numbers(n, indptr, indices, core)
    return core


def default_threads():
    """OpenMP threads of a walk call: ``OMP_NUM_THREADS`` when set, one in
    a ``multiprocessing`` worker (a pool over files already owns the
    cores), else 0, OpenMP's default (the whole machine)."""
    env = os.environ.get("OMP_NUM_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return 1 if multiprocessing.parent_process() is not None else 0


def simulate_walks(A, walk_length, walk_time, seed, weighted=True,
                   n_threads=None) -> np.ndarray:
    """``walk_time`` walks of ``walk_length + 1`` nodes from every node of
    the scipy CSR ``A``, int32[n * walk_time, walk_length + 1], row
    ``start * walk_time + rep`` starting at ``start``.  Walk ``w`` draws
    from its own splitmix64 stream of (``seed``, w), so the walks depend on
    the seed alone, not on the thread count.  Weighted hops sample by the
    row's inclusive running weight sum (inverse CDF); a walk at an isolated
    node stays there."""
    indptr, indices = _csr_arrays(A)
    n = A.shape[0]
    nnz = int(indptr[-1])
    cumw = None
    if weighted and nnz > 0:
        # each row's inclusive running sum: the global running sum less
        # its value where the row starts
        data = np.asarray(A.data, dtype=np.float64)[:nnz]
        g = np.cumsum(data)
        row_base = np.repeat(g[indptr[:-1] - 1] * (indptr[:-1] > 0),
                             np.diff(indptr))
        cumw = np.ascontiguousarray(g - row_base)
    nt = default_threads() if n_threads is None else max(0, int(n_threads))
    walks = np.empty((n * walk_time, walk_length + 1), dtype=np.int32)
    load().hg_simulate_walks(
        n, indptr, indices,
        None if cumw is None else cumw.ctypes.data_as(ctypes.c_void_p),
        np.int32(walk_time), np.int32(walk_length), np.uint64(seed),
        np.int32(nt), walks)
    return walks
