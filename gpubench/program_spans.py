"""The program's own spans and counters in the traced run
(``ctgcn_torch.training.profiling``), and the spans' device intervals set
on the device trace's clock.

The program keeps a trace of a training call that runs while a
``torch.profiler`` records (``profiling.last_trace``): in the traced run,
the job's ``learn`` call.  ``session`` takes it (or ``ctx["program"]``
where that is given) once, as plain data: spans (name, parent, host start
and end in ``time.perf_counter_ns``, device ms between the span's events,
device ms from the trace's first event to the span's first),
the counters' change and the SpMM calls (nonzeros, rows, columns read, d,
kernel).  A program without spans, or a trace that is not the traced
run's, gives None, and the readers of its metrics report nothing.

One clock: each span's two CUDA events are on the device's own clock
(``device_start_ms`` from the trace's first event, ``device_ms`` between
them), which ``align`` sets on the device trace's by the spans whose first
device op the trace names (``ANCHORS``): each batch's ``batch_inputs``
(two host-to-device copies), each epoch's ``readback`` (the loss's
device-to-host copy) and each ``spmm`` (the launch's first kernel); the
n-th such span is matched to the n-th such op, or group.  Where that op
was queued behind another, the device reaches the span's first event as
the other ends and starts the op one launch gap later, so op start less
event time is the offset between the clocks there.  The profiler's clock
drifts against the events' (0.3-1 us a ms) and now and then steps (by
15 us to 5 ms), so the offset is interpolated between neighbouring
anchors; the residual is the largest miss of an anchor by the others,
which a step sets.  A span's device interval, its events on the trace's
clock, holds the device work it enqueued and the idle between; device
idle is named by the innermost span whose device interval holds it."""
from __future__ import annotations

import bisect
import importlib
import statistics
import sys

from program import PACKAGE

#: the engine's host spans inside an epoch
ENGINE = ("batch_plan", "batch_inputs", "optimizer", "readback")
#: the spans whose first device op the trace names, and that op's name
#: (a part of it): each batch's two host-to-device copies, the loss's
#: read back, and the first kernel of each SpMM launch
ANCHORS = {"batch_inputs": ("HtoD",), "readback": ("DtoH",),
           "spmm": ("rowwalk", "blockpar_chunk", "blockpar_regs")}
#: an op that starts this soon (us) after the op before it ended was
#: queued behind it (launch gaps 6-17 us, the benchmark's markers
#: included); after an idle device, 60 us or more
BUSY_US = 30.0


def session(ctx):
    """{"spans": [(name, parent, start_ns, end_ns, device_ms,
    device_start_ms)],
    "counters": {name: n}, "spmm": [(nnz, rows, cols, d, kernel)]} of
    the traced run, or None.  Taken once a run (kept in ``ctx``)."""
    if "program" in ctx:
        return ctx["program"]
    ctx["program"] = out = _from_program(ctx.get("trace"))
    return out


def _from_program(trace):
    if not trace:
        return None
    prof = importlib.import_module(PACKAGE + ".training.profiling")
    # a checkout from before the program kept spans has no last_trace,
    # and its readers report nothing
    last = getattr(prof, "last_trace", None)
    kept = last() if last is not None else None
    if kept is None:
        return None
    counters = dict(kept.counters or {})
    if counters.get("engine.epochs") != trace["epochs"]:
        return None
    return {"spans": [tuple(s) for s in kept.spans], "counters": counters,
            "spmm": list(kept.spmm)}


def epochs(prog):
    return prog["counters"].get("engine.epochs", 0)


def anchors(prog, ops):
    """[(event us, op start us)]: each ``ANCHORS`` span's first event, on
    the events' clock, and the start of its first device op, on the
    trace's, where that op was queued behind the op before it (the event
    then completes as that op ends, and the span's op starts one launch
    gap later).  The n-th span of a kind is matched to the n-th group of
    its ops; a kind whose ops are not a whole number a span is left
    out."""
    ops = sorted(ops, key=lambda o: o[1])
    before, end = [], float("-inf")
    for _, start, dur in ops:
        before.append(end)
        end = max(end, start + dur)
    found = []
    for name, marks in ANCHORS.items():
        spans = [s for s in prog["spans"] if s[0] == name and s[5] is not None]
        at = [i for i, op in enumerate(ops) if any(m in op[0] for m in marks)]
        per = len(at) // len(spans) if spans else 0
        if not per or per * len(spans) != len(at):
            continue
        for k, s in enumerate(spans):
            i = at[k * per]
            if ops[i][1] - before[i] < BUSY_US:
                found.append((s[5] * 1e3, ops[i][1]))
    return found


def align(prog, ops):
    """(clock, misses): ``clock`` the sorted [(event us, offset us)] of
    the anchors, trace us = event us + the offset interpolated between
    them (``on_trace``); ``misses`` each anchor's miss (us) by the clock
    of the others ([] with one anchor).  None without an anchor."""
    clock = sorted((ev, start - ev) for ev, start in anchors(prog, ops))
    if not clock:
        return None
    return clock, [abs(off - on_trace(clock[:i] + clock[i + 1:], ev) + ev)
                   for i, (ev, off) in enumerate(clock)] if clock[1:] else []


def on_trace(clock, ev):
    """Event us ``ev`` on the trace's clock: the offset interpolated
    between the anchors around it, the nearest one's outside them."""
    i = bisect.bisect(clock, (ev, float("inf")))
    if i == 0:
        return ev + clock[0][1]
    if i == len(clock):
        return ev + clock[-1][1]
    (e0, o0), (e1, o1) = clock[i - 1], clock[i]
    return ev + o0 + (o1 - o0) * (ev - e0) / (e1 - e0)


def device_spans(prog, clock):
    """[(name, start us, end us)]: each span's device interval, between
    its events, on the trace's clock, in the order opened."""
    return [(s[0], on_trace(clock, s[5] * 1e3),
             on_trace(clock, (s[5] + s[4]) * 1e3))
            for s in prog["spans"] if s[4] is not None and s[5] is not None]


def _busy(ops):
    out = []
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], start + dur)
        else:
            out.append([start, start + dur])
    return out


def idle_gaps(dspans, ops):
    """[(start, end)] us: the gaps between the device's busy intervals
    over the traced epochs' device intervals (``dspans``), from the first
    device op in them (the wait for the window's first op left out)."""
    ep = [(a, b) for name, a, b in dspans if name == "epoch"]
    if not ep:
        return []
    lo, hi = ep[0][0], ep[-1][1]
    busy = [b for b in _busy(ops) if lo < b[1] and b[0] < hi]
    if not busy:
        return []
    gaps, t = [], max(lo, busy[0][0])
    for start, end in busy:
        if start > t:
            gaps.append((t, start))
        t = max(t, end)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def _innermost(dspans):
    """[(start, end, name)]: the timeline cut where a device interval
    opens or closes, each piece named by the innermost interval over it
    (the one opened last), None where none is."""
    events = []
    for i, (_, a, b) in enumerate(dspans):
        if b > a:
            events += [(a, 1, i), (b, 0, i)]
    events.sort()
    out, stack, t_prev = [], [], None
    for t, kind, i in events:
        if t_prev is not None and t > t_prev:
            out.append((t_prev, t, dspans[stack[-1]][0] if stack else None))
        if kind:
            stack.append(i)
        else:
            stack.remove(i)
        t_prev = t
    return out


def _overlap(gaps, pieces):
    """{piece name: us of ``gaps`` inside the ``pieces`` [(start, end,
    name)], sorted and disjoint}, None for the rest of the gaps."""
    out, j = {}, 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k, covered = j, 0.0
        while k < len(pieces) and pieces[k][0] < b:
            lap = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if lap > 0:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + lap
                covered += lap
            k += 1
        if b - a > covered:
            out[None] = out.get(None, 0.0) + (b - a - covered)
    return out


def idle_in(dspans, gaps, name):
    """Device idle us inside the device intervals of the spans ``name``
    (their children included)."""
    pieces = []
    for n, a, b in sorted(d for d in dspans if d[0] == name and d[2] > d[1]):
        if pieces and a < pieces[-1][1]:          # inside the one before
            pieces[-1] = (pieces[-1][0], max(b, pieces[-1][1]), name)
        else:
            pieces.append((a, b, name))
    return _overlap(gaps, pieces).get(name, 0.0)


def clock(ctx):
    """{"clock", "anchors", "residual_us", "median_miss_us", "step_us"
    (the largest change of offset between neighbouring anchors), "spans"
    (device intervals), "gaps", "idle_us": {innermost span: us}} of the
    traced run, or None; computed once a run (kept in ``ctx``), and its
    numbers written to standard error."""
    if "program_clock" in ctx:
        return ctx["program_clock"]
    prog, tr = session(ctx), ctx.get("trace")
    out = None
    found = align(prog, tr["ops"]) if prog and tr and tr.get("ops") else None
    if found is not None:
        anchors_, misses = found
        dspans = device_spans(prog, anchors_)
        gaps = idle_gaps(dspans, tr["ops"])
        out = {"clock": anchors_, "anchors": len(anchors_),
               "residual_us": max(misses) if misses else None,
               "median_miss_us": statistics.median(misses) if misses else None,
               "step_us": max((abs(b[1] - a[1]) for a, b
                               in zip(anchors_, anchors_[1:])), default=None),
               "spans": dspans, "gaps": gaps,
               "idle_us": _overlap(gaps, _innermost(dspans))}
        idle = {k or "-": v for k, v in out["idle_us"].items()}
        print(f"program spans: clock residual {out['residual_us']!r} us, "
              f"median miss {out['median_miss_us']!r} us, largest step "
              f"{out['step_us']!r} us, over {len(anchors_)} anchors; device "
              f"idle us by innermost span {idle}", file=sys.stderr)
    ctx["program_clock"] = out
    return out


def work_ms(ctx, name):
    """The device ms an epoch between the events of the spans ``name``
    less the device idle between them: their device work.  None without
    such a span or the clock."""
    prog, found = session(ctx), clock(ctx)
    if not prog or not epochs(prog) or found is None:
        return None
    ms = [s[4] for s in prog["spans"] if s[0] == name]
    if not ms or None in ms:
        return None
    idle = idle_in(found["spans"], found["gaps"], name)
    return (sum(ms) - idle / 1e3) / epochs(prog)
