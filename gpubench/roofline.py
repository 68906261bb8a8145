"""The least time of an SpMM ``out = A @ x`` at width d (``chip_smoke.py``
``_bound``): the larger of the bytes the product must move (A's values
and column indices, 8 bytes a nonzero, its row pointers, the rows of x
that A's columns name, and out, each once, 4 bytes an element) over the
HBM rate, and its 2 nnz d FLOPs over the FP32 peak."""


def spmm_bound_s(nnz, n_rows, x_rows, d, peaks):
    flops = 2.0 * nnz * d
    moved = nnz * 8 + (n_rows + 1) * 4 + x_rows * d * 4 + n_rows * d * 4
    return max(flops / peaks["fp32_flops"], moved / peaks["hbm_bytes_per_s"])
