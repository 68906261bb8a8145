# coding: utf-8
"""Opt-in ``torch.profiler`` tracing of training loops, and the driver's
two diagnostics (port of ``ctgcn_tpu/training/profiling.py``).

Set ``profile_dir`` in the method's embedding config (or the
``CTGCN_TPU_PROFILE_DIR`` environment variable) and each trainer writes
one Chrome/TensorBoard trace of its steady-state epochs into that
directory: the host's activity, and the device's kernels on a CUDA
device.  Epoch 0 is left out, as in the JAX package: it holds the first
use of every kernel (lazy builds, allocator growth).

``CTGCN_TPU_PHASE_TIMES`` (any non-empty value) prints ``[phase]`` lines
for a window's setup, training, embedding forward, export and model save
(``PhaseClock``); ``CTGCN_TPU_MEM_REPORT`` prints each window's peak
device memory (``mem_report``).  The driver reads both once per run.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class EpochTracer:
    """Start/stop ``torch.profiler`` around a steady-state epoch window.

    Usage in an epoch loop::

        tracer = EpochTracer(profile_dir, n_epochs, device)
        for i in range(n_epochs):
            tracer.before_epoch(i)
            with tracer.annotate(i):
                ... run epoch ...
            tracer.after_epoch(i)
        tracer.close()

    The trace covers epochs ``first..last``: ``after_epoch(last)`` stops
    the profiler, and ``close`` writes the file, named as
    ``torch.profiler.tensorboard_trace_handler`` names it
    (``<host>_<pid>.<ms>.pt.trace.json``; ``self.path``), so the export
    falls in no epoch's time.  ``close`` also stops a trace that the loop
    ended early.
    """

    #: first epoch captured (0-indexed; epoch 0 is the warm-up)
    FIRST = 1
    #: number of epochs captured
    SPAN = 3

    def __init__(self, profile_dir, n_epochs, device="cpu"):
        self.dir = profile_dir or os.environ.get("CTGCN_TPU_PROFILE_DIR")
        first = min(self.FIRST, max(n_epochs - 1, 0))
        self.first = first
        self.last = min(first + self.SPAN - 1, n_epochs - 1)
        self.device = torch.device(device)
        self.active = False
        self.path = None
        self._prof = None
        self._stopped_at = None

    def before_epoch(self, i):
        if self.dir and i == self.first and not self.active:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self.active = True

    def annotate(self, i):
        if self.active:
            return torch.profiler.record_function("epoch")
        return contextlib.nullcontext()

    def after_epoch(self, i):
        if self.active:
            self._stopped_at = i
            if i >= self.last:
                self._stop()

    def close(self):
        if self.active:            # loop shorter than the capture window
            self._stop()
        if self._prof is None:
            return
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(
            self.dir, f"{os.uname().nodename}_{os.getpid()}."
                      f"{time.time_ns() // 1_000_000}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        print(f"profiler trace written to {self.dir} "
              f"(epochs {self.first}..{self._stopped_at})", flush=True)

    def _stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.active = False


class PhaseClock:
    """``[phase]`` lines (the JAX package's ``CTGCN_TPU_PHASE_TIMES``):
    ``lap(name)`` waits for ``device``, prints the seconds since the last
    lap under ``name`` and starts the next; off, it does nothing."""

    def __init__(self, enabled, device="cpu"):
        self.enabled = bool(enabled)
        self.device = torch.device(device)
        self.t0 = time.time()

    def lap(self, name):
        if not self.enabled:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.time()
        print(f"  [phase] {name}: {now - self.t0:.2f}s", flush=True)
        self.t0 = now


def mem_report(idx, device):
    """Print window ``idx``'s peak device memory since the last reset and
    the memory in use, then reset the peak (the JAX package's
    ``CTGCN_TPU_MEM_REPORT`` line); the CPU keeps no allocator
    statistic."""
    device = torch.device(device)
    if device.type != "cuda":
        print(f"idx = {idx}: no allocator statistic on the CPU", flush=True)
        return
    print(f"idx = {idx}: peak_bytes_in_use="
          f"{torch.cuda.max_memory_allocated(device)}, bytes_in_use="
          f"{torch.cuda.memory_allocated(device)}", flush=True)
    torch.cuda.reset_peak_memory_stats(device)
