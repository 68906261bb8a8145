"""The readings the limits of a cell's comparison are set from.

    python3 gpubench/calibrate.py --workload <cell> --seeds <n>... \
        [--control <k>]

For each seed, in one process: the cell's set-up and checked steps, then
the reference over the same inputs; the numbers compared (the program
against the reference in float32) are the sound runs' readings.  On the
first ``k`` seeds also the control: the reference with TF32 GEMMs put in
the program's place, against the reference in float32, judged by the
harness's own verdict with the same exact checks (``control_correct``
has to come out false; the run exits with 1 where it does not).  One
JSON line a seed on standard output.  No window is measured."""
import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["TRITON_CACHE_DIR"] = os.path.join(os.path.dirname(HERE),
                                              ".gpubench_cache", "triton")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", choices=("unchanged", "half"),
                    help="plant this fault in the timed path (the faults' "
                    "readings)")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import gc

    import harness
    dev = torch.device("cuda", 0)
    cell = harness.Cell(a.workload)
    control_ok = True
    for i, seed in enumerate(a.seeds):
        t0 = time.time()
        with harness.fault(cell, a.fault):
            prog = harness.program_side(cell, seed, dev, 0, False, t0,
                                        measure=False)
        t_ref = time.time()
        ref = harness.reference_side(cell, seed, dev, prog)
        t_ref = time.time() - t_ref
        checks, ok = harness.verdict(cell, ref["exact"], ref["numbers"])
        line = {"workload": a.workload, "seed": seed, "fault": a.fault,
                "correct": ok, "exact": ref["exact"], "stats": ref["stats"],
                "numbers": ref["numbers"], "where": ref["where"],
                "losses": prog["losses"], "ref_losses": ref["ref_losses"],
                "draw_stats": prog["draw_stats"], "reference_s": t_ref,
                "grad1": [prog["readings"]["grad1"], ref["run"][1]],
                "delta": [prog["readings"]["delta"], ref["run"][2]]}
        if i < a.control:
            (line["control"], line["control_where"], c_checks,
             line["control_correct"]) = harness.control(cell, seed, dev, ref)
            failed = [k for k, (v, lim) in c_checks.items() if not v <= lim]
            line["control_failed"] = failed
            print(f"control {a.workload} seed {seed}: correct "
                  f"{line['control_correct']}, fails {failed}",
                  file=sys.stderr)
            control_ok = control_ok and not line["control_correct"]
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        shutil.rmtree(prog["work"], ignore_errors=True)
        del prog, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0 if control_ok else 1


if __name__ == "__main__":
    sys.exit(main())
