"""The benchmark of ctgcn_torch on the GPU: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints the result as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit), and the same checks as the last lines
of standard error.  Exits with another code than 0, and prints no
result, without a CUDA device (or with fewer than the cell asks for), and
when a module of JAX or of the JAX package is loaded in this process."""
import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
CACHE = os.path.join(CHECKOUT, ".gpubench_cache")
# the program under test is imported from the checkout's root
sys.path.insert(0, CHECKOUT)
# every kernel cache inside the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def process_start():
    """When this process started, on the epoch clock (the import time of
    this file where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fp:
            boot = next(int(line.split()[1]) for line in fp
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return T_IMPORT


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    cell = [w for w in bench["workloads"] if w["name"] == a.workload]
    if not cell:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 2
    chips = cell[0]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available: no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import harness
    import program
    try:
        result, ref = harness.run(a.workload, a.seed, a.seconds, a.trace,
                                torch.device("cuda", 0), process_start(),
                                chips=chips)
    except harness.ForbiddenModules as exc:
        print(f"modules of JAX or the JAX package loaded: {exc}",
              file=sys.stderr)
        return 3
    found = program.forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    numbers = ref["numbers"]
    print(f"reference_s {ref['seconds']!r} {ref['stages']}",
          file=sys.stderr)
    for name, value in numbers.items():
        if name not in result["checks"]:
            print(f"number {name} {value!r} (not compared)", file=sys.stderr)
    for name, value in ref["stats"].items():
        print(f"draw statistic {name} {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        state = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {state}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
