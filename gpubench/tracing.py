"""The traced run's reading of the device: kernels from ``torch.profiler``
(device activity only: with the host's too, summing a launch-heavy epoch's
events takes minutes), the union of their busy intervals, and the device
time inside the benchmark's own ranges.

A range is bracketed on the device by two marker kernels (``mark``), so
that the kernels between them in stream order are the range's whatever
the host does; the host logs each marker's range and side in launch
order, and the reader pairs the log with the markers it finds in the
trace (all work runs on one stream, whose order is launch order)."""
from __future__ import annotations

import torch


def mark():
    """Launch one marker kernel on the current stream."""
    torch.cuda._sleep(0)


def marker_name():
    """The name the profiler gives a marker kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark()
        torch.cuda.synchronize()
    names = {name for name, _, _ in device_ops(prof)}
    if len(names) != 1:
        raise RuntimeError(f"a marker showed as {sorted(names)}")
    return names.pop()


def device_ops(prof):
    """[(name, start us, duration us)] of every device operation (kernels,
    copies, sets) of a finished profile, in start order."""
    out = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False):
            continue
        out.append((ev.name, float(ev.time_range.start),
                    float(ev.time_range.elapsed_us())))
    out.sort(key=lambda e: e[1])
    return out


def union_us(ops):
    """Length of the union of the ops' [start, start + duration)."""
    total, end = 0.0, None
    for _, start, dur in sorted(ops, key=lambda e: e[1]):
        stop = start + dur
        if end is None or start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def split_markers(ops, marker, log):
    """(the ops that are not markers, the range each was launched in or
    "-", {range: device us inside it}) where ``log`` lists (range,
    "open"/"close") per marker in launch order.  When the trace's markers
    do not match the log, every label is "-" and the ranges are None."""
    plain = [op for op in ops if op[0] != marker]
    if sum(op[0] == marker for op in ops) != len(log):
        return plain, ["-"] * len(plain), None
    labels, inside, depth = [], {name: 0.0 for name, _ in log}, {}
    seen = 0
    for op in ops:
        if op[0] == marker:
            name, side = log[seen]
            seen += 1
            depth[name] = depth.get(name, 0) + (1 if side == "open" else -1)
            continue
        now = [name for name, d in depth.items() if d > 0]
        labels.append(now[0] if now else "-")
        for name in now:
            inside[name] += op[2]
    if any(depth.values()):
        return plain, ["-"] * len(plain), None
    return plain, labels, inside


def kernel_class(name):
    """The class of a device operation by its name (``chip_smoke.py``'s
    classes)."""
    if "rowwalk" in name or "blockpar" in name:
        return "spmm"
    low = name.lower()
    if "gemm" in low or "xmma" in name or "cutlass" in name:
        return "gemm"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "other"


def breakdown(ops, labels, limit=10):
    """{"device_ops": the ``limit`` op names of most device time, with
    seconds; "idle_gaps": the ``limit`` longest gaps between busy
    intervals, named by the range the op after the gap was launched in
    (``labels``, ``split_markers``'s) and that op, with seconds}."""
    by_name = {}
    for name, _, dur in ops:
        by_name[name] = by_name.get(name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
    gaps, end = [], None
    for i, (name, start, dur) in enumerate(ops):
        if end is not None and start > end:
            gaps.append((f"{labels[i]}: before {name[:80]}",
                         (start - end) / 1e6))
        end = start + dur if end is None else max(end, start + dur)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in top],
            "idle_gaps": [[n, s] for n, s in gaps[:limit]]}
