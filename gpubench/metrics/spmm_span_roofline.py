"""Share (%) of the SpMMs' least time (``roofline.spmm_bound_s`` of each
launch the program recorded, from its plan's nonzeros, rows and columns
read and its width, whatever kernel served it) in the device work of the
program's ``spmm`` spans (one a launch of the CSR kernels: the time
between its two events less the device idle inside it,
``program_spans.work_ms``)."""
from roofline import spmm_bound_s

import program_spans


def read(ctx):
    prog, peaks = program_spans.session(ctx), ctx["peaks"]
    if not prog or not peaks or not prog["spmm"]:
        return None
    ms = program_spans.work_ms(ctx, "spmm")
    if not ms or ms <= 0:
        return None
    bound = sum(spmm_bound_s(nnz, rows, cols, d, peaks)
                for nnz, rows, cols, d, _ in prog["spmm"])
    return 100.0 * bound / (ms * program_spans.epochs(prog) / 1e3)
