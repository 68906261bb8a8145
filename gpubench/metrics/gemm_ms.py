"""Device milliseconds an epoch of the GEMM class (cuBLAS and CUTLASS
kernels, by name) in the traced run."""
from tracing import kernel_class


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    us = sum(d for name, _, d in tr["ops"] if kernel_class(name) == "gemm")
    return us / 1e3 / tr["epochs"] if us else None
