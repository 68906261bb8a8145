"""Share (%) of the SpMMs' least time (``roofline.spmm_bound_s`` of each
call's plan and width, whatever kernel serves it) in their device time
(the device time between the markers around each call of the SpMM entry
point, forward and backward)."""
from roofline import spmm_bound_s


def read(ctx):
    tr, peaks = ctx["trace"], ctx["peaks"]
    if not tr or not peaks or not tr["ranges"] or not tr["spmm_calls"]:
        return None
    us = tr["ranges"].get("spmm")
    if not us:
        return None
    bound = sum(spmm_bound_s(*call, peaks) for call in tr["spmm_calls"])
    return 100.0 * bound / (us / 1e6)
