# coding: utf-8
"""Opt-in ``torch.profiler`` tracing of training loops, and the driver's
two diagnostics (port of ``ctgcn_tpu/training/profiling.py``).

Set ``profile_dir`` in the method's embedding config (or the
``CTGCN_TPU_PROFILE_DIR`` environment variable) and each trainer writes
one Chrome/TensorBoard trace of its steady-state epochs into that
directory: the host's activity, and the device's kernels on a CUDA
device, with the program's spans (below) as named ranges.  Epoch 0 is
left out, as in the JAX package: it holds the first use of every kernel
(lazy builds, allocator growth).

``CTGCN_TPU_PHASE_TIMES`` (any non-empty value) prints ``[phase]`` lines
for a window's setup, training, embedding forward, export and model save
(``PhaseClock``); ``CTGCN_TPU_MEM_REPORT`` prints each window's peak
device memory (``mem_report``).  The driver reads both once per run.

Spans and counters, the program's own measure of its layers:

  * ``span(name)`` marks a region.  Off (the default) it costs one check
    and returns a shared no-op context.  On, it keeps the region's name,
    its parent span and its host times (``time.perf_counter_ns``), enters
    a profiler range of that name (a RecordFunction entered from C++,
    ``cpu_op`` in an exported trace) and, on a CUDA device, records a pair
    of ``torch.cuda.Event`` on the work's stream, read only after the
    trace (the span's device interval); it launches no kernel, copy or
    set.
    ``backward_span`` marks the backward of a region (identity autograd
    functions, applied only while tracing is on).
  * ``count(name, n)`` adds to a host counter; counters are always on.
  * ``tracing(device)`` turns spans on inside and yields the ``Trace``,
    which holds the spans, the counters' change and the SpMM calls once
    it ends.  ``EpochTracer`` opens one while its profiler runs, and the
    training loops open one while any ``torch.profiler`` records them
    (``traced_if_profiled``), kept as ``last_trace()``.

The spans: ``epoch``, and inside it ``batch_plan`` (the batch matrix),
``batch_inputs`` (its host-to-device copies), ``optimizer`` (``zero_grad``
and ``step``) and ``readback`` (the epoch's loss read back and the wait),
from ``engine.UnsupervisedEmbedding.learn_embedding`` (the supervised
loop: ``epoch`` alone); ``loss``, the negative-sampling loss's forward
and its backward (``losses``); ``core_rnn``, the core-axis RNN's forward
and backward (``ops.rnn``); ``spmm``, every launch of the CSR kernels
(``ops.bsr_spmm._launch``).  The counters: ``engine.epochs``;
``core_rnn.slot_steps`` and ``core_rnn.valid_slot_steps`` (core slots
stepped, and those of them valid, counted from the pyramid's host
build); ``spmm.launches.<kernel>``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch

#: the host counters, always on ({name: int})
_COUNTERS: dict = {}
#: the open trace (the flag ``span`` checks), and the last one ended
_active = None
_last = None
_NULL = contextlib.nullcontext()


def count(name, n=1):
    """Add ``n`` to the host counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter(name):
    """The host counter ``name`` (0 before its first count)."""
    return _COUNTERS.get(name, 0)


def reset_counters(prefix=""):
    """Set the counters whose names start with ``prefix`` to 0."""
    for name in [k for k in _COUNTERS if k.startswith(prefix)]:
        del _COUNTERS[name]


class Span(NamedTuple):
    """A span of a finished trace: ``parent`` is the index of the span
    open around it (-1 at the top), ``start_ns``/``end_ns`` its host times
    (``time.perf_counter_ns``; ``end_ns`` -1 if it never closed),
    ``device_ms`` the device time between its events and
    ``device_start_ms`` when the device reached its first event, from the
    trace's first event (both None off CUDA)."""
    name: str
    parent: int
    start_ns: int
    end_ns: int
    device_ms: float | None
    device_start_ms: float | None


class Trace:
    """The spans, counters and SpMM calls of one ``tracing`` block.

    ``spans`` (``Span``s in the order opened) reads the events, so read it
    after the traced work, outside any profiled window; ``counters`` is
    each counter's change over the block ({name: n}, changed ones only);
    ``spmm`` one (nonzeros, rows, columns read, d, kernel name) a kernel
    launch, host numbers of its plan (``CsrPlan.cols_read``)."""

    def __init__(self, device):
        device = torch.device(device)
        # the events go on the stream the work runs on, looked up once
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.spmm = []
        self.counters = None
        self._records = []   # [name, parent, t0, t1, event0, event1, range]
        self._stack = []
        self._base = dict(_COUNTERS)
        self._spans = None

    def _event(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def open(self, name):
        # record_function's RecordFunction entered from C++: about a
        # microsecond, where the Python ``record_function`` takes ten
        rng = torch._C._profiler._RecordFunctionFast(name)
        rng.__enter__()
        ev = self._event()
        idx = len(self._records)
        self._records.append([name, self._stack[-1] if self._stack else -1,
                              time.perf_counter_ns(), -1, ev, None, rng])
        self._stack.append(idx)
        return idx

    def close(self, idx):
        rec = self._records[idx]
        rec[3] = time.perf_counter_ns()
        rec[5] = self._event()
        rec[6].__exit__(None, None, None)
        rec[6] = None
        self._stack.remove(idx)

    def _end(self):
        self.counters = {k: v - self._base.get(k, 0)
                         for k, v in _COUNTERS.items()
                         if v != self._base.get(k, 0)}

    @property
    def spans(self):
        if self._spans is None:
            out = []
            first = self._records[0][4] if self._records else None
            for name, parent, t0, t1, ev0, ev1, _ in self._records:
                ms = start = None
                if ev1 is not None:
                    ev1.synchronize()
                    ms = ev0.elapsed_time(ev1)
                    start = first.elapsed_time(ev0)
                out.append(Span(name, parent, t0, t1, ms, start))
            self._spans = out
            self._records = None
        return self._spans


class _SpanBlock:
    __slots__ = ("trace", "name", "idx")

    def __init__(self, trace, name):
        self.trace, self.name = trace, name

    def __enter__(self):
        self.idx = self.trace.open(self.name)

    def __exit__(self, *exc):
        self.trace.close(self.idx)


def span(name):
    """A context that marks its block as the span ``name`` while tracing
    is on; a shared no-op context while it is off."""
    if _active is None:
        return _NULL
    return _SpanBlock(_active, name)


def active():
    """The open ``Trace``, or None while tracing is off."""
    return _active


@contextlib.contextmanager
def tracing(device=None):
    """Spans on inside the block; yields its ``Trace``, whose counters are
    set when the block ends.  Inside an open trace it yields that one,
    which its own block ends.  ``device``: where the work runs (default:
    CUDA when there is one); its events are recorded on CUDA alone."""
    global _active, _last
    if _active is not None:
        yield _active
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    trace = Trace(device)
    _active = trace
    try:
        yield trace
    finally:
        _active = None
        trace._end()
        _last = trace


def traced_if_profiled(device):
    """``tracing(device)`` when a ``torch.profiler`` records and no trace is
    open, so that a caller who profiles a training loop from outside gets
    its spans (``last_trace``); else a no-op context."""
    if _active is None and torch._C._autograd._profiler_enabled():
        return tracing(device)
    return _NULL


def last_trace():
    """The ``Trace`` of the last ``tracing`` block that ended, or None."""
    return _last


class _BackwardSpan:
    def __init__(self, name):
        self.name = name
        self.idx = None

    def enter(self, x):
        return _BackwardClose.apply(x, self)

    def exit(self, y):
        return _BackwardOpen.apply(y, self)


class _NoBackwardSpan:
    @staticmethod
    def enter(x):
        return x

    @staticmethod
    def exit(y):
        return y


_NO_BACKWARD = _NoBackwardSpan()


def backward_span(name):
    """The span ``name`` over the backward of a region: ``exit(y)`` on the
    region's output (its backward node runs first) opens it, ``enter(x)``
    on the region's input (its node runs last) closes it.  While tracing
    is on both are identity autograd functions; while it is off a shared
    object whose two methods return the tensor itself, adding no node."""
    return _NO_BACKWARD if _active is None else _BackwardSpan(name)


class _BackwardOpen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bspan):
        ctx.bspan = bspan
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if _active is not None:
            ctx.bspan.idx = _active.open(ctx.bspan.name)
        return g, None


class _BackwardClose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bspan):
        ctx.bspan = bspan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        bspan = ctx.bspan
        if _active is not None and bspan.idx is not None:
            _active.close(bspan.idx)
            bspan.idx = None
        return g, None


class EpochTracer:
    """Start/stop ``torch.profiler`` around a steady-state epoch window,
    with the program's spans on (``tracing``) while it records.

    Usage in an epoch loop::

        tracer = EpochTracer(profile_dir, n_epochs, device)
        for i in range(n_epochs):
            tracer.before_epoch(i)
            with span("epoch"):
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
        self._tracing = None
        self._stopped_at = None

    def before_epoch(self, i):
        if self.dir and i == self.first and not self.active:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._tracing = tracing(self.device)
            self._tracing.__enter__()
            self.active = True

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
        self._tracing.__exit__(None, None, None)
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
