"""The readings the ``gram_limits`` of a VGRNN cell are set from.

    python3 gpubench/calibrate_gram.py --workload <cell> \
        --runs <mode>:<seed>...

Each run, in one process: the cell's set-up and its first checked step
(the dense softplus sum's calls that ``gram_faults`` checks are the first
batch's), with the program's Gram as it is (``sound``), with its GEMMs at
TF32 (``tf32``, the rest of the program in float32) or with z rounded to
bfloat16 before it (``bf16``); then the job's reference inputs, which
hold each call to the reference's.  One JSON line a run on standard
output: the exact checks and the statistics (``gram_sum_gap``,
``gram_grad_gap``).  The limits sit between the sound runs' largest and
the TF32 runs' least.  No window is measured."""
import argparse
import contextlib
import importlib
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["TRITON_CACHE_DIR"] = os.path.join(os.path.dirname(HERE),
                                              ".gpubench_cache", "triton")


@contextlib.contextmanager
def _tf32_gram():
    import torch

    from program import PACKAGE, patched
    base = importlib.import_module(PACKAGE + ".losses")._SoftplusGramSum

    def at_tf32(fn, *a):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn(*a)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    class TF32(base):
        @staticmethod
        def forward(ctx, z):
            return at_tf32(base.forward, ctx, z)

        @staticmethod
        def backward(ctx, g):
            return at_tf32(base.backward, ctx, g)

    with patched(PACKAGE + ".losses", "_SoftplusGramSum", lambda o: TF32):
        yield


def _bf16_gram():
    from program import PACKAGE, patched
    return patched(PACKAGE + ".losses", "softplus_gram_sum",
                   lambda orig: lambda z: orig(z.bfloat16().float()))


MODES = {"sound": contextlib.nullcontext, "tf32": _tf32_gram,
         "bf16": _bf16_gram}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="<mode>:<seed>, mode one of " + ", ".join(MODES))
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import harness
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.Cell(a.workload)
    cell.spec = dict(cell.spec, checked_steps=1)
    for run in a.runs:
        mode, seed = run.split(":")
        t0 = time.time()
        with MODES[mode]():
            prog = harness.program_side(cell, int(seed), dev, 0, False, t0,
                                        measure=False)
        inputs = harness.reference_inputs(cell, int(seed), dev, prog)
        print(json.dumps({"workload": a.workload, "mode": mode,
                          "seed": int(seed), "exact": inputs["exact"],
                          "stats": inputs["stats"],
                          "seconds": time.time() - t0}), flush=True)
        shutil.rmtree(prog["work"], ignore_errors=True)
        del prog, inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
