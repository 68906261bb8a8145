#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ctgcn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- CTGCN-C, U-neg, on a temporary copy of the
bundled UCI data at the full width of ``configs/uci.json`` (hid 500,
embed 128, T = 7, batch 2048, neg_num 20, Q 20) with the BSR kernel backend
(``core_backend: "pallas"``) for 3 epochs -- and holds each hand-written
kernel against its plain PyTorch version.  Phases, one line each:

  1. build      the CUDA kernels from ``ctgcn_torch/csrc`` (nvcc, sm_90a);
  2. preprocess k-core pyramids and walk tables through ``ctgcn_torch.main``;
  3. kernels    each kernel at the main path's shapes (snapshot 2004-05 of
                the window, both plans, d = 512 and 128) against both plain
                versions (CSR gather + index_add_, dense blocks), the
                autograd gradient of ``block_spmm``, times of kernel,
                plain version and one library call on both plans at both
                widths, and each kernel's bound;
     parity     a small CTGCN-C forward and gradient, kernels on the GPU
                against the plain versions on the CPU;
  4. main path  the embedding task with the launch counters reset just
                before and read just after;
     profile    an epoch's device time by kernel class (``torch.profiler``);
  5. the ``kernels`` JSON line, the card's name and power limit, and the
     final ``{"ok": true, "device": ...}`` line.

Any failure exits non-zero.  Without a GPU, or outside a checkout of the
repository, the script stops before any result.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SNAPSHOT = "2004-05"
EPOCHS = 3
#: kernel vs plain version: |k - p| <= RTOL * |p| + ATOL_REL * max|p|
#: (f32 sums taken in another order; no TF32 on either side)
RTOL, ATOL_REL = 1e-5, 1e-5
#: small CTGCN-C, GPU kernels vs CPU plain versions (see phase_parity)
PARITY_TOL = 1e-4
#: published H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32
#: outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: device cycles queued ahead of a timed run (about 10 ms on an H100)
SLEEP_CYCLES = 20_000_000


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _phase(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _time_ms(fn, iters=20, warmup=3):
    """Mean device ms of ``fn`` over back-to-back calls: what a call's
    inputs left in L2 stays there for the next.  A device sleep queued
    before the timed calls lets the host enqueue them all before the first
    runs, so the host's own cost per call (Python, a wrapper's checks) is
    not timed, unless ``fn`` waits for the device itself."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms_cold(fn, dev, iters=10):
    """Mean device ms of ``fn`` with L2 flushed before each call (a 128 MB
    buffer, over twice the 50 MB L2, is rewritten in between)."""
    import torch

    flush = torch.empty(32 * 1024 * 1024, device=dev)
    fn()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _plan_csr(plan):
    """The plan's matrix as a torch sparse CSR tensor on its device (the
    library yardstick's input), from the plan's own CSR arrays."""
    import torch

    return torch.sparse_csr_tensor(plan.csr_ptr.long(), plan.csr_col.long(),
                                   plan.csr_val, (plan.n_rows, plan.n_cols),
                                   check_invariants=False)


def _bound(nnz, d, n_rows, n_cols):
    """Least time for ``out = A @ x`` at these inputs: the larger of the
    bytes moved (A's nnz values and column indices and its row pointers,
    x and out, each once) over the HBM rate and its 2 * nnz * d FLOPs
    over the FP32 peak."""
    flops = 2.0 * nnz * d
    bytes_ = nnz * 8 + (n_rows + 1) * 4 + (n_cols + n_rows) * d * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return {
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "nnz": int(nnz), "flops": flops, "bytes": bytes_,
    }


def _check_close(name, got, ref, rtol=RTOL, atol_rel=ATOL_REL):
    import torch

    err = (got - ref).abs()
    tol = rtol * ref.abs() + atol_rel * float(ref.abs().max())
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max()):.3e} "
                             f"over tolerance (rtol {rtol}, atol "
                             f"{atol_rel} * max|ref|)")
    return float(err.max())


KERNELS = {"bsr_spmm_blockpar": "ctgcn_tpu/ops/pallas_spmm.py:146",
           "bsr_spmm_rowwalk": "ctgcn_tpu/ops/pallas_spmm.py:97"}
WIDTHS = (512, 128)   # hid 500 and embed 128, padded to 128: the SpMM widths


def phase_kernels(cfg, dev):
    """Each kernel at the main path's shapes (snapshot 2004-05) against
    both plain versions, on both plans and padded plans, at both widths;
    then each kernel's time on both plans at both widths beside the
    library call and the bound."""
    import torch

    from ctgcn_torch.data.formats import sorted_dir
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.training.driver import get_data_loader

    args = dict(cfg)
    loader = get_data_loader(args)
    t = sorted_dir(args["core_base_path"]).index(SNAPSHOT)
    t0 = time.time()
    pyr = loader.get_core_adj_list(args["core_base_path"], 0,
                                   args["duration"], core_backend="pallas")
    _phase("kernels", window_plans_built_seconds=time.time() - t0,
           blocks_fwd=[p.num_blocks for p in pyr.plan_fwd],
           blocks_t=[p.num_blocks for p in pyr.plan_t],
           nnz=[p.nnz for p in pyr.plan_fwd],
           max_row_nnz_fwd=[p.max_row_nnz for p in pyr.plan_fwd],
           max_row_nnz_t=[p.max_row_nnz for p in pyr.plan_t])
    hosts = {"forward": pyr.plan_fwd[t], "transpose": pyr.plan_t[t]}
    plans = {k: h.to(dev) for k, h in hosts.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {k: torch.randn(p.n_cols, max(WIDTHS), device=dev,
                             generator=gen) for k, p in plans.items()}
    # the plan each kernel gets on the main path
    main_plan = {B.dispatch(p).__name__: k for k, p in plans.items()}
    errs = {}
    for name in KERNELS:
        kern = getattr(B, name)
        for pk, host in hosts.items():
            # the dense oracle needs the blocks, which device plans leave
            # behind; padded plans must give the same product
            with_blocks = host.to(dev, blocks=True)
            padded = B.pad_block_plan(host, host.num_blocks + 37).to(dev)
            for dd in WIDTHS:
                inp = inputs[pk][:, :dd].contiguous()
                got = kern(plans[pk], inp)
                ref = B.bsr_spmm_csr_plain(plans[pk], inp)
                err = _check_close(f"{name} {pk} d={dd}", got, ref)
                errs[name, pk, dd] = (err, err / float(ref.abs().max()))
                _check_close(f"{name} {pk} d={dd} vs dense blocks", got,
                             B.bsr_spmm_plain(with_blocks, inp))
                _check_close(f"{name} {pk} d={dd} padded plan",
                             kern(padded, inp), ref)
                del got, ref
            del with_blocks, padded
    torch.cuda.synchronize()

    results = {}
    times = {name: [] for name in KERNELS}
    for pk, plan in plans.items():
        csr = _plan_csr(plan)
        for dd in WIDTHS:
            inp = inputs[pk][:, :dd].contiguous()
            bound = _bound(plan.nnz, dd, plan.n_rows, plan.n_cols)
            library_ms = _time_ms(lambda: torch.sparse.mm(csr, inp))
            _check_close(f"torch.sparse.mm {pk} d={dd}",
                         torch.sparse.mm(csr, inp),
                         B.bsr_spmm_csr_plain(plan, inp))
            for name in KERNELS:
                kern = getattr(B, name)
                ms = _time_ms(lambda: kern(plan, inp))
                row = {"plan": pk, "d": dd, "ms": ms,
                       "library_ms": library_ms,
                       "bound_ms": bound["bound_ms"],
                       "bound_by": bound["bound_by"]}
                times[name].append(row)
                if main_plan[name] != pk or dd != max(WIDTHS):
                    continue
                err, rel_err = errs[name, pk, dd]
                plain_ms = _time_ms(
                    lambda: B.bsr_spmm_csr_plain(plan, inp), iters=5,
                    warmup=1)
                if name == "bsr_spmm_rowwalk":
                    # the walk order's worth: the same walk in row order
                    natural = dataclasses.replace(
                        plan, row_order=torch.arange(
                            plan.n_rows, dtype=torch.int32, device=dev))
                    extra = {"ms_natural_row_order": _time_ms(
                        lambda: kern(natural, inp))}
                else:
                    extra = {}
                results[name] = {
                    "name": name, "route": "cuda",
                    "source": "ctgcn_torch/csrc/bsr_spmm.cu",
                    "replaces": KERNELS[name],
                    "status": "matches its plain versions",
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "library_ms": library_ms, "plan": pk,
                    "ms_cold_l2": _time_ms_cold(lambda: kern(plan, inp),
                                                dev), **extra}
                _phase("kernels", kernel=name, plan=pk,
                       shape=[plan.n_rows, plan.n_cols, dd],
                       max_abs_err=err, max_rel_err=rel_err,
                       tolerance=f"rtol {RTOL} + atol {ATOL_REL} * "
                                 "max|plain|",
                       ms=ms, ms_cold_l2=results[name]["ms_cold_l2"],
                       **extra,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library="torch.sparse.mm (CSR)", **bound)
        del csr
    for name in KERNELS:
        results[name]["times"] = times[name]
        _phase("kernels", kernel=name, times=times[name])

    # autograd through block_spmm: layer 1's forward and backward kernels
    fwd, tr = plans["forward"], plans["transpose"]
    n, dm = pyr.n_nodes, 500
    xs = torch.randn(n, dm, device=dev, generator=gen, requires_grad=True)
    w = torch.randn(fwd.n_rows, dm, device=dev, generator=gen)
    (B.block_spmm(fwd, tr, xs) * w).sum().backward()
    g_pad = torch.nn.functional.pad(w, (0, 512 - dm)).contiguous()
    ref = B.bsr_spmm_csr_plain(tr, g_pad)[:n, :dm]
    gerr = _check_close("block_spmm grad", xs.grad, ref)
    _phase("kernels", check="block_spmm autograd grad", max_abs_err=gerr)
    return results


def phase_parity(dev):
    """A small CTGCN-C: forward and all parameter gradients with the
    kernels on the GPU against the plain versions on the CPU.  Node 0 is a
    hub of degree 150, so the transpose plan's longest row (the hub's
    degree in each of the K = 3 slots) passes ``ROWWALK_MAX_ROW`` and both
    kernels run."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from ctgcn_torch.nn.core_models import CTGCN
    from ctgcn_torch.ops import bsr_spmm as B
    from ctgcn_torch.ops.pyramid import build_core_pyramid, stack_pyramids

    rng = np.random.default_rng(0)
    n, T, hid = 1800, 2, 500
    pyrs = []
    for _ in range(T):
        dense = (rng.random((n, n)) < 0.002) * rng.random((n, n))
        dense[0, rng.choice(np.arange(1, n), 150, replace=False)] = 1.0
        a = sp.csr_matrix(np.triu(dense, 1) + np.triu(dense, 1).T)
        deg = np.asarray((a != 0).sum(1)).ravel()
        mats = [sp.csr_matrix(a.multiply(np.outer(deg >= k, deg >= k)))
                for k in (4, 2, 1)]
        pyrs.append(build_core_pyramid(mats, n, num_slots=3))
    pyr = stack_pyramids(pyrs)
    if {B.dispatch(q).__name__ for q in pyr.plan_fwd + pyr.plan_t} != {
            "bsr_spmm_rowwalk", "bsr_spmm_blockpar"}:
        raise AssertionError("the parity model does not reach both kernels")
    model = CTGCN(n, hid, 64, 1, 2, T,
                  generator=torch.Generator().manual_seed(0))
    out = []
    for d in (torch.device("cpu"), dev):
        m = model.to(d)
        m.zero_grad(set_to_none=True)
        y = m(None, pyr.to(d))
        torch.tanh(y).square().sum().backward()
        out.append((y.detach().cpu(),
                    {k: p.grad.detach().cpu()
                     for k, p in m.named_parameters()}))
    (yc, gc), (yg, gg) = out
    # two GEMM libraries and a deep chain (MLP, 2 x (SpMM, K-step GRU,
    # LayerNorm), time GRU, LayerNorm): f32, but a looser bound than one op
    tol = {"rtol": PARITY_TOL, "atol_rel": PARITY_TOL}
    errs = {"forward": _check_close("parity forward", yg, yc, **tol)}
    for k in gc:
        errs[k] = _check_close(f"parity grad {k}", gg[k], gc[k], **tol)
    _phase("parity", tolerance=PARITY_TOL, n=n, T=T, hid=hid,
           max_abs_err_forward=errs["forward"],
           max_abs_err_grads=max(v for k, v in errs.items()
                                 if k != "forward"))


def _kernel_class(name):
    if "rowwalk" in name or "blockpar" in name:
        return "bsr_spmm kernels"
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name:
        return "GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "other (elementwise, reductions, indexing)"


def phase_profile(cfg, dev, epochs=2):
    """Where a training epoch's time goes on the card: the window's setup
    (plans, walk tables, model, all moved to the card), then the main
    path's trainer after one warm-up epoch, ``epochs`` epochs timed on the host
    clock, then ``epochs`` more under ``torch.profiler`` for the device
    time by kernel class.  The idle share is 1 - device busy time / the
    unprofiled epoch time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctgcn_torch.training.driver import build_trainer, get_data_loader

    args = dict(cfg)
    t0 = time.time()
    loader = get_data_loader(args)
    trainer = build_trainer("CTGCN-C", args, loader, 0, args["duration"], dev,
                            torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    kw = dict(batch_size=args["batch_size"], lr=args["lr"],
              weight_decay=args["weight_decay"], model_file=None,
              export=False, verbose=False)
    trainer.learn_embedding(epoch=1, **kw)
    # the epoch's wall time without the profiler's host overhead
    epoch_ms = 1e3 * sum(
        trainer.learn_embedding(epoch=epochs, **kw)["epoch_seconds"]) / epochs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.learn_embedding(epoch=epochs, **kw)
        torch.cuda.synchronize()
        profiled_ms = (time.time() - t0) * 1e3 / epochs
    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # device-side ranges of host annotations (e.g. Optimizer.step)
        # span kernels counted on their own
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0
                and not getattr(ev, "is_user_annotation", False)
                and "#" not in ev.key):
            per_kernel[ev.key] = (dev_us / 1e3 / epochs, ev.count // epochs)
    busy = sum(ms for ms, _ in per_kernel.values())
    classes = {}
    for name, (ms, n) in per_kernel.items():
        c = classes.setdefault(_kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += n
    if not per_kernel:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    _phase("profile", window_setup_seconds=setup_s, epochs=epochs,
           epoch_ms=epoch_ms,
           epoch_ms_profiled=profiled_ms, device_busy_ms=busy,
           device_idle_share=max(0.0, 1 - busy / epoch_ms),
           kernel_launches=sum(n for _, n in per_kernel.values()),
           by_class={k: {"ms": v[0], "launches": v[1]}
                     for k, v in sorted(classes.items(),
                                        key=lambda kv: -kv[1][0])},
           top_kernels=[{"name": k[:90], "ms": v[0], "launches": v[1]}
                        for k, v in top])


def main():
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        return _fail(f"missing package: {exc}")
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False)")
    if not ((ROOT / "ctgcn_torch" / "csrc").is_dir()
            and (ROOT / "configs" / "uci.json").is_file()
            and (ROOT / "data" / "uci" / "1.format").is_dir()):
        return _fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
           torch=torch.__version__, cuda=torch.version.cuda)

    # 1. build
    from ctgcn_torch.ops.cuda_build import build_kernels, load_kernels

    t0 = time.time()
    _, nvcc_s, log = build_kernels()
    load_kernels()
    _phase("build", seconds=time.time() - t0, nvcc_seconds=nvcc_s,
           ptxas=[line.split("info    : ")[-1] for line in log.splitlines()
                  if "registers" in line])

    work = ROOT / "tmp_run" / f"chip_smoke_{os.getpid()}"
    try:
        # 2. preprocessing on a temporary copy of data/uci
        base = work / "uci"
        for sub in ("1.format", "nodes_set"):
            shutil.copytree(ROOT / "data" / "uci" / sub, base / sub)
        with open(ROOT / "configs" / "uci.json") as fp:
            uci = json.load(fp)
        pre = dict(uci["preprocessing"]["CTGCN-C"], base_path=str(base))
        emb = dict(uci["embedding"]["CTGCN-C"], base_path=str(base),
                   core_backend="pallas", epoch=EPOCHS)
        cfg_path = work / "uci_pallas.json"
        with open(cfg_path, "w") as fp:
            json.dump({"preprocessing": {"CTGCN-C": pre},
                       "embedding": {"CTGCN-C": emb}}, fp, indent=1)
        from ctgcn_torch import main as cli

        t0 = time.time()
        cli.main([f"--config={cfg_path}", "--task=preprocessing",
                  "--method=CTGCN-C"])
        _phase("preprocess", seconds=time.time() - t0)

        # 3. kernels at the main path's shapes, and small-model parity
        kernels = phase_kernels(emb, dev)
        phase_parity(dev)

        # 4. the main path, counters reset just before and read just after
        from ctgcn_torch.data.formats import (read_embedding_csv,
                                              read_node_list)
        from ctgcn_torch.ops import bsr_spmm as B

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        B.bsr_spmm_blockpar.launches = 0
        B.bsr_spmm_rowwalk.launches = 0
        t0 = time.time()
        results = cli.main([f"--config={cfg_path}", "--task=embedding",
                            "--method=CTGCN-C"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"bsr_spmm_blockpar": B.bsr_spmm_blockpar.launches,
                    "bsr_spmm_rowwalk": B.bsr_spmm_rowwalk.launches}
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [l for r in results for l in r["losses"]]
        if len(losses) != EPOCHS or not all(np.isfinite(losses)):
            raise AssertionError(f"losses {losses}")
        for name, n_launch in launches.items():
            if n_launch == 0:
                raise AssertionError(f"{name} never launched on the main "
                                     "path")
            kernels[name]["launches"] = n_launch
            kernels[name]["status"] += ", launched on the main path"
        nodes = read_node_list(base / "nodes_set" / "nodes.csv")
        emb_dir = base / emb["embed_folder"]
        shapes = []
        for f in sorted(os.listdir(emb_dir)):
            names, arr = read_embedding_csv(emb_dir / f)
            if (names != nodes or arr.shape != (len(nodes), emb["embed_dim"])
                    or not np.isfinite(arr).all()):
                raise AssertionError(f"embedding {f}: {arr.shape}")
            shapes.append(list(arr.shape))
        if len(shapes) != emb["duration"]:
            raise AssertionError(f"{len(shapes)} embedding CSVs")
        _phase("main", seconds=wall,
               setup_seconds=results[0]["setup_seconds"],
               train_seconds=results[0]["cost_time"],
               epoch_seconds=results[0]["epoch_seconds"],
               export_seconds=results[0]["export_seconds"], losses=losses,
               launches=launches, max_memory_allocated=peak,
               embedding_csvs=shapes)

        # 5. where an epoch's time goes (after the counted run)
        phase_profile(emb, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [kernels["bsr_spmm_blockpar"],
                                  kernels["bsr_spmm_rowwalk"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
