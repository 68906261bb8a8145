"""What the benchmark takes from the package under test, ``ctgcn_torch``:
its preprocessing, the trainer ``training.driver.build_trainer`` makes for
window 0 (the job, ``jobs/<job>.py``, drives it), and, around the job's
calls, the optimizer the trainer builds and the SpMM entry point
(``ops.bsr_spmm.block_spmm_raw``, which every SpMM of the CSR kernels
passes through, forward and backward).  Nothing here changes what the
program computes."""
from __future__ import annotations

import contextlib
import importlib
import math

import torch

PACKAGE = "ctgcn_torch"
#: the top-level modules that may not be loaded in a run's process: JAX,
#: its libraries and the JAX package of which ``ctgcn_torch`` is the port
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ctgcn_tpu")


def forbidden_modules(modules):
    """The loaded module names whose top-level name, the part before the
    first dot, is one of ``FORBIDDEN`` (compared whole)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


#: the keys of a configuration file that are the benchmark's, not the
#: port's config keys
BENCH_KEYS = ("name", "source", "model", "data", "precision", "cores",
              "departures", "reduced", "assumed")


def program_args(cfg, traffic, work, seed):
    """The port's config dict for window 0 of the configuration ``cfg``
    under the job ``traffic``, with its data and artifacts under
    ``work``."""
    args = {k: v for k, v in cfg.items() if k not in BENCH_KEYS}
    args.update(traffic["program"])
    args.update(base_path=work, origin_folder="1.format",
                node_file="nodes_set/nodes.csv", file_sep="\t",
                embed_folder="2.embedding", model_folder="model",
                start_idx=0, end_idx=cfg["duration"] - 1,
                duration=cfg["duration"], seed=int(seed),
                export=False, record_time=False, load_model=False)
    if cfg.get("cores"):
        args.update(core_folder="cores", generate_core=True)
    return args


def preprocess(args):
    from ctgcn_torch.preprocessing import preprocess as run
    run(args["method"], args)


def build(args, device):
    """The trainer of window 0 (its inputs on ``device``), with the
    family's memory knobs at their defaults whatever the environment."""
    from ctgcn_torch.training.driver import (build_trainer, core_knobs,
                                             get_data_loader)
    torch.backends.cuda.matmul.allow_tf32 = False
    loader = get_data_loader(args)
    time_length = min(args["duration"], loader.max_time_num)
    trainer = build_trainer(args["method"], args, loader, 0, time_length,
                            device, torch.Generator().manual_seed(0),
                            seed=args["seed"], knobs=core_knobs(args, env={}))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return trainer


def load_params(named, params):
    """Copy the benchmark's parameters into the program's leaves
    ``named`` ({name: parameter}); the names and shapes have to be the
    leaves', all of them."""
    if sorted(named) != sorted(params):
        raise RuntimeError(
            f"the model's parameters {sorted(set(named) ^ set(params))[:6]} "
            "differ from the reference's")
    with torch.no_grad():
        for name, p in named.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise RuntimeError(f"{name}: {tuple(p.shape)} against "
                                   f"{tuple(params[name].shape)}")
            p.copy_(params[name])


@contextlib.contextmanager
def patched(module_name, attr, make):
    """``module.attr`` replaced by ``make(original)`` inside the block."""
    mod = importlib.import_module(module_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield orig
    finally:
        setattr(mod, attr, orig)


@contextlib.contextmanager
def optimizer_readings(named, params0, steps, readings):
    """Read the optimizer the next training call builds over the leaves
    ``named`` ({name: parameter}): after its
    first step, each leaf's loss gradient as the optimizer got it (Adam's
    first moment over 1 - beta1, less the weight decay's share, from the
    parameters ``params0`` the step started from); after step ``steps``,
    the norm of each leaf's change from ``params0``.  Norms in float64,
    into ``readings["grad1"]`` and ``readings["delta"]``."""
    names = {id(p): n for n, p in named.items()}

    def make(orig):
        def make_optimizer(ps, lr, weight_decay=0.0):
            opt = orig(ps, lr, weight_decay)
            step, count = opt.step, [0]

            def counted(*a, **kw):
                # counted here, not by a step hook: a hook runs once for
                # each hooked class of the optimizer's step chain
                out = step(*a, **kw)
                count[0] += 1
                group = opt.param_groups[0]
                beta1, wd = group["betas"][0], group["weight_decay"]
                if count[0] == 1:
                    # a step that kept no moment gives no reading
                    out_ = {}
                    for p in group["params"]:
                        st = opt.state[p]
                        out_[names[id(p)]] = (
                            float((st["exp_avg"].double() / (1 - beta1)
                                   - wd * params0[names[id(p)]].double())
                                  .norm())
                            if "exp_avg" in st else math.nan)
                    readings["grad1"] = out_
                if count[0] == steps:
                    readings["delta"] = {
                        names[id(p)]: float(
                            (p.detach().double()
                             - params0[names[id(p)]].double()).norm())
                        for p in group["params"]}
                return out
            opt.step = counted
            return opt
        return make_optimizer

    with patched(f"{PACKAGE}.training.engine", "make_optimizer", make):
        yield


@contextlib.contextmanager
def spmm_ranges(ranges, calls):
    """Bracket every SpMM of the CSR kernels with markers (``ranges``:
    the tracer's (open, close) pair) and log each call's plan and width
    into ``calls``."""
    open_, close = ranges

    def make(orig):
        def block_spmm_raw(plan, x):
            open_("spmm")
            out = orig(plan, x)
            close("spmm")
            calls.append((plan, int(x.shape[1])))
            return out
        return block_spmm_raw

    with patched(f"{PACKAGE}.ops.bsr_spmm", "block_spmm_raw", make):
        yield


def plan_stats(plan):
    """(nonzeros, rows, distinct columns named) of a CSR plan."""
    return (int(plan.nnz), int(plan.n_rows),
            int(torch.unique(plan.csr_col).numel()))
