"""One run of one cell: set-up, the checked steps, the measured window,
the traced run, then the plain reference and the verdict.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic file ``traffic/<traffic>.json`` (the
training job, whose code is ``jobs/<job>.py`` and which owns the engine
call, the leaves, the loss's draws and its fault), its cell file
``workloads/<cell>.json`` (the limits of its comparison), the reference
model ``reference/<model>.py`` the configuration names, a recorder
``draws/<kind>.py`` for each kind of random draw of that model's forward,
its data ``data/<data>/`` and one reader ``metrics/<metric>.py`` a
per-layer metric."""
from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import program  # noqa: E402
import tracing  # noqa: E402
from reference import graph  # noqa: E402
from reference.nn import init_params, precision  # noqa: E402
from reference.train import gaps  # noqa: E402


def _json(*parts):
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


class Cell:
    """A cell of ``BENCHMARK.json`` and everything it names."""

    def __init__(self, name, root=CHECKOUT):
        bench = _json(root, "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        conf = [c for c in bench["configs"]
                if c["name"] == self.entry["config"]]
        self.cfg = _json(root, conf[0]["file"])
        self.traffic = _json(HERE, "traffic", self.entry["traffic"] + ".json")
        self.spec = _json(HERE, "workloads", name + ".json")
        self.model = importlib.import_module("reference." + self.cfg["model"])
        self.job = importlib.import_module("jobs." + self.traffic["job"])
        self.draws = [importlib.import_module("draws." + d)
                      for d in self.model.DRAWS]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in moved]


def data_dir(name):
    """The frozen data set ``data/<name>/``, every file checked against its
    ``SHA256SUMS``."""
    root = os.path.join(HERE, "data", name)
    with open(os.path.join(root, "SHA256SUMS")) as fp:
        for line in fp:
            digest, rel = line.split()
            with open(os.path.join(root, rel), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != digest:
                    raise SystemExit(f"data/{name}/{rel}: SHA-256 differs "
                                     "from SHA256SUMS")
    return root


def work_dir(cfg):
    """A fresh copy of the configuration's data under the run's TMPDIR,
    where preprocessing writes."""
    work = tempfile.mkdtemp(prefix="gpubench-")
    src = data_dir(cfg["data"])
    for sub in ("1.format", "nodes_set"):
        shutil.copytree(os.path.join(src, sub), os.path.join(work, sub))
    return work


class Spans:
    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name, device):
        _sync(device)
        t0 = time.time()
        yield
        _sync(device)
        self.seconds[name] = self.seconds.get(name, 0.0) + time.time() - t0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seed32(seed):
    """The program's seed of a run: its walks, batches and draws."""
    return int(seed) % (1 << 32)


def param_seed(seed):
    """The seed of a run's parameters, a stream apart from the program's
    (drawn from the same seed, the program's first uniform draws would be
    the parameters' own)."""
    return int(np.random.SeedSequence((seed32(seed), 0x5EED)).generate_state(
        1, np.uint64)[0])


def program_side(cell, seed, device, seconds, trace, t_start, measure=True):
    """Set-up, the checked steps, the window and, with ``trace``, the
    traced run; the program's state is freed before this returns.
    Without ``measure``, set-up and the checked steps alone (the
    readings of ``calibrate.py``).  Returns what the verdict and the
    metrics read."""
    s = seed32(seed)
    spans = Spans()
    work = work_dir(cell.cfg)
    args = program.program_args(cell.cfg, cell.traffic, work, s)
    with spans("preprocess", device):
        program.preprocess(args)
    with spans("window_setup", device):
        trainer = program.build(args, device)
    n = trainer.node_num
    spec = cell.job.param_spec(cell.model, cell.cfg, n)
    params0 = init_params(spec, param_seed(seed), device)
    program.load_params(cell.job.leaves(trainer), params0)

    steps = cell.spec["checked_steps"]
    log, readings = {}, {}
    drawn = [d.Recorder() for d in cell.draws]
    with contextlib.ExitStack() as stack:
        stack.enter_context(cell.job.recorder(log))
        stack.enter_context(program.optimizer_readings(
            cell.job.leaves(trainer), params0, steps, readings))
        for r in drawn:
            stack.enter_context(r)
        checked = cell.job.learn(trainer, args, steps, s)
    del params0
    records = cell.job.records(log, steps)
    del log
    faults = sum(r.attach(records["steps"]) for r in drawn)
    draw_stats = [x for r in drawn for x in r.stats]
    del drawn
    captured = {"adjs": program_adjs(trainer)}
    if not measure:
        del trainer
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return dict(work=work, args=args, n=n, spec=spec, records=records,
                    readings=readings, captured=captured,
                    losses=checked["losses"], draw_faults=faults,
                    draw_stats=draw_stats)
    # one epoch as the window runs it, nothing recorded: its time fixes
    # the window's epoch count (the recorders slow the checked epochs)
    t_epoch = cell.job.learn(trainer, args, 1, s + 3)["epoch_seconds"][0]
    epochs = max(1, int(seconds / t_epoch))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    watched = {}
    with cell.job.watch(watched):
        _sync(device)
        t_w = time.time()
        setup_s = t_w - t_start
        window = cell.job.learn(trainer, args, epochs, s + 1)
        _sync(device)
        window_s = time.time() - t_w
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = dict(work=work, args=args, n=n, spec=spec, spans=spans.seconds,
               records=records, readings=readings, captured=captured,
               losses=checked["losses"], draw_faults=faults,
               draw_stats=draw_stats, epochs=epochs, window_s=window_s,
               setup_s=setup_s, watched=watched,
               peak=peak, window_losses=window["losses"])
    if trace:
        out["trace"] = traced_run(cell, trainer, args, epochs, t_epoch, s,
                                  device)
        if device.type == "cuda":
            out["peak"] = max(peak, torch.cuda.max_memory_allocated(device))
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def program_adjs(trainer):
    """The program's zoo adjacency of the window as host (rows, cols,
    vals), one a snapshot; None for a window of pyramids."""
    adjs = trainer.data.get("adjs")
    if not isinstance(adjs, tuple) or not hasattr(adjs[0], "rows"):
        return None
    return [(g.rows.cpu().numpy(), g.cols.cpu().numpy(),
             g.vals.cpu().numpy()) for g in adjs]


def traced_run(cell, trainer, args, epochs, t_epoch, s, device):
    """A second window under ``torch.profiler`` with device activity only,
    its SpMMs and loss bracketed with markers: as many epochs as fill the
    cell's ``trace_seconds``, at least one and at most the window's."""
    from torch.profiler import ProfilerActivity, profile
    marker = tracing.marker_name()
    log, calls = [], []

    def open_(name):
        tracing.mark()
        log.append((name, "open"))

    def close(name):
        tracing.mark()
        log.append((name, "close"))

    n_ep = max(1, min(epochs, int(cell.spec["trace_seconds"] / t_epoch)))
    with program.spmm_ranges((open_, close), calls), \
            cell.job.trace_ranges((open_, close)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _sync(device)
            t0 = time.time()
            cell.job.learn(trainer, args, n_ep, s + 2)
            _sync(device)
            wall = time.time() - t0
    ops = tracing.device_ops(prof)
    plain, labels, inside = tracing.split_markers(ops, marker, log)
    stats = {}
    spmm = []
    for plan, d in calls:
        if id(plan) not in stats:
            stats[id(plan)] = program.plan_stats(plan)
        spmm.append(stats[id(plan)] + (d,))
    return dict(epochs=n_ep, window_s=wall, ops=plain, ranges=inside,
                busy_s=tracing.union_us(plain) / 1e6, spmm_calls=spmm,
                breakdown=tracing.breakdown(plain, labels))


def reference_inputs(cell, seed, device, prog):
    """The reference's own window, walk tables and the exact checks of
    what set-up derived and of the draws; the recorded steps on the
    device."""
    s = seed32(seed)
    cfg = cell.cfg
    _, adjs = graph.read_window(prog["work"], cfg["duration"])
    prep = cell.model.prepare(adjs, cfg, device)
    exact = dict(cell.model.setup_checks(prep, prog["args"], prog["captured"]))
    steps = _to(prog["records"]["steps"], device)
    tabs, job_exact, stats = cell.job.reference_inputs(cell, adjs, s, device,
                                                       prog, steps)
    exact.update(job_exact)
    exact["draw_faults"] = exact.get("draw_faults", 0) + prog["draw_faults"]
    return dict(prep=prep, tabs=tabs, steps=steps, exact=exact, stats=stats,
                flops=cell.job.flops(cell.model, prep, cfg, cell.traffic))


def _to(v, device):
    """``v`` with every tensor in it, through lists and dicts, on
    ``device``."""
    if torch.is_tensor(v):
        return v.to(device)
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    if isinstance(v, list):
        return [_to(x, device) for x in v]
    return v


def reference_follow(cell, seed, device, inputs, prec="fp32"):
    """The reference's first forward (the embeddings of the first batch)
    and its steps, at the GEMM precision ``prec``: (embeddings,
    (losses, first gradients' norms, changes' norms))."""
    params0 = init_params(cell.job.param_spec(cell.model, cell.cfg,
                                              inputs["prep"].n),
                          param_seed(seed), device)
    with precision(prec):
        with torch.no_grad():
            embs = cell.model.forward(params0, inputs["prep"], cell.cfg,
                                      **inputs["steps"][0][0].get("draws", {}))
        run = cell.job.follow(cell.model, cell.cfg, cell.traffic,
                              inputs["prep"], inputs["tabs"], params0,
                              inputs["steps"])
    return embs, run


def compare(got_embs, got_run, ref_embs, ref_run):
    """The numbers compared (``reference.train.gaps``) and ``embed_gap``,
    the largest gap of the first batch's embeddings over the largest
    reference embedding."""
    numbers, where = gaps(got_run, ref_run)
    got = got_embs.to(ref_embs.device)
    numbers["embed_gap"] = float((got - ref_embs).abs().max()
                                 / ref_embs.abs().max())
    return numbers, where


def reference_side(cell, seed, device, prog):
    """The plain reference over the same data, seeds and draws: the exact
    checks and the numbers compared with the program's readings."""
    t0 = time.time()
    inputs = reference_inputs(cell, seed, device, prog)
    _sync(device)
    t1 = time.time()
    embs, run = reference_follow(cell, seed, device, inputs)
    _sync(device)
    stages = {"inputs_s": t1 - t0, "steps_s": time.time() - t1}
    numbers, where = compare(
        prog["records"]["embs"],
        (prog["losses"], prog["readings"]["grad1"], prog["readings"]["delta"]),
        embs, run)
    return dict(exact=inputs["exact"], numbers=numbers, where=where,
                stats=inputs["stats"], flops=inputs["flops"],
                ref_losses=run[0], inputs=inputs, embs=embs, run=run,
                stages=stages)


def control(cell, seed, device, ref):
    """The control: the reference at TF32 GEMMs put in the program's
    place, against the reference in float32, with the same exact checks.
    (its numbers, the leaves they came from, its checks, whether it came
    out correct, which it must not)."""
    embs, run = reference_follow(cell, seed, device, ref["inputs"], "tf32")
    numbers, where = compare(embs, run, ref["embs"], ref["run"])
    checks, ok = verdict(cell, ref["exact"], numbers)
    return numbers, where, checks, ok


def verdict(cell, exact, numbers):
    """{check: (value, limit)} and whether every value is within its
    limit; an exact check has the limit 0."""
    limits = cell.spec["limits"]
    checks = {k: (v, 0) for k, v in exact.items()}
    checks.update({k: (v, limits[k]) for k, v in numbers.items()
                   if k in limits})
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return checks, ok


def metrics(cell, prog, ref, trace):
    """The cell's end-to-end metrics (``trace`` 0) or its per-layer ones
    (``trace`` 1), each read by its own reader."""
    if not trace:
        values = {"epoch_ms": 1e3 * prog["window_s"] / prog["epochs"],
                  "peak_mem_gb": prog["peak"] / 1e9,
                  "setup_s": prog["setup_s"]}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end if m["name"] in values}
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    ctx = dict(spans=prog["spans"], epochs=prog["epochs"],
               window_s=prog["window_s"], trace=prog.get("trace"),
               flops_per_epoch=ref["flops"], precision=cell.cfg["precision"],
               peaks=_json(HERE, "peaks.json").get(kind))
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module("metrics." + m["name"])
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(chips, prog):
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(prog["peak"])}
    try:
        import subprocess
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(q.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    if "trace" in prog:
        info["busy_s"] = prog["trace"]["busy_s"]
        info["window_s"] = prog["trace"]["window_s"]
    return info


def run(name, seed, seconds, trace, device, t_start, chips=1):
    """One run of cell ``name``: (the result's keys, the check lines)."""
    cell = Cell(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    prog = program_side(cell, seed, device, seconds, trace, t_start)
    found = program.forbidden_modules(sys.modules)
    if found:
        raise ForbiddenModules(found)
    t_ref = time.time()
    ref = reference_side(cell, seed, device, prog)
    ref["seconds"] = time.time() - t_ref
    checks, ok = verdict(cell, ref["exact"], ref["numbers"])
    losses = list(prog["losses"]) + list(prog["window_losses"])
    result = {"correct": ok,
              "attempted": len(losses),
              "failed": sum(not math.isfinite(x) for x in losses),
              "metrics": metrics(cell, prog, ref, trace),
              "device": (device_info(chips, prog) if device.type == "cuda"
                         else {"platform": "cpu", "kind": "cpu", "count": 0,
                               "memory_peak_bytes": 0})}
    if trace and prog.get("trace"):
        result["breakdown"] = prog["trace"]["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    shutil.rmtree(prog["work"], ignore_errors=True)
    return result, ref


class ForbiddenModules(RuntimeError):
    pass


FAULTS = ("unchanged", "half")


@contextlib.contextmanager
def fault(cell, name):
    """The timed path broken underneath (tests and ``calibrate.py``
    only): "unchanged", the optimizer's step returns the parameters as
    they were; "half", the job's own (``jobs/<job>.py`` ``half``): each
    batch's loss leaves out the second half of its rows and takes the
    mean over the rest."""
    if name is None:
        yield
    elif name == "unchanged":
        with program.patched(program.PACKAGE + ".training.engine", "_Adam",
                             lambda orig: type("_Still", (orig,), {
                                 "step": lambda self, closure=None: None})):
            yield
    elif name == "half":
        with cell.job.half():
            yield
    else:
        raise ValueError(f"fault {name!r}, not one of {FAULTS}")


def run_cpu(name, seed, fault_name=None, control_run=False, seconds=0.2):
    """The test-only entry: one run of cell ``name`` on the CPU (no
    trace), optionally with a ``fault`` planted in the timed path, and,
    with ``control_run``, the control (``control``).  Returns the
    result, the numbers and, for the control, its numbers and
    verdict."""
    device = torch.device("cpu")
    cell = Cell(name)
    with fault(cell, fault_name):
        prog = program_side(cell, seed, device, seconds, False, time.time())
    ref = reference_side(cell, seed, device, prog)
    checks, ok = verdict(cell, ref["exact"], ref["numbers"])
    out = {"correct": ok, "checks": {k: list(v) for k, v in checks.items()},
           "numbers": ref["numbers"], "stats": ref["stats"],
           "epochs": prog["epochs"],
           "metrics": metrics(cell, prog, ref, False),
           "modules": program.forbidden_modules(sys.modules)}
    if control_run:
        out["control"], _, c_checks, out["control_correct"] = control(
            cell, seed, device, ref)
        out["control_checks"] = {k: list(v) for k, v in c_checks.items()}
    shutil.rmtree(prog["work"], ignore_errors=True)
    return out
