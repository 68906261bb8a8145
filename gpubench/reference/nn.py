"""Dense building blocks of the reference: GEMMs at a stated precision,
the GRU step, LayerNorm, sparse products, and the seeded parameters."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.nn import functional as F

#: the GEMM precision of the reference: "fp32" (TF32 off, what the
#: configurations state) or "tf32" (the control: on the card TF32 GEMMs;
#: on the CPU each GEMM operand rounded to TF32's 10-bit mantissa)
_PRECISION = ["fp32"]


@contextlib.contextmanager
def precision(name):
    """Run the reference's GEMMs at ``name`` inside the block."""
    if name not in ("fp32", "tf32"):
        raise ValueError(f"precision {name!r}")
    prev = (_PRECISION[0], torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    _PRECISION[0] = name
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        (_PRECISION[0], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _tf32(t):
    """t rounded to the nearest TF32 value (ties to even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def mm(a, b):
    """a @ b; on the CPU under "tf32" the operands are rounded first (the
    gradient passes straight through the rounding)."""
    if _PRECISION[0] == "tf32" and not a.is_cuda:
        a = a + (_tf32(a.detach()) - a.detach())
        b = b + (_tf32(b.detach()) - b.detach())
    return a @ b


def linear(x, w, b):
    """x @ w^T + b for torch-layout weights [out, in]."""
    return mm(x, w.t()) + b


def gru(x, h, p):
    """One GRU step (gates reset, update, new; torch layout) with
    parameters p = (w_ih, w_hh, b_ih, b_hh)."""
    w_ih, w_hh, b_ih, b_hh = p
    H = w_hh.shape[1]
    gi, gh = linear(x, w_ih, b_ih), linear(h, w_hh, b_hh)
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1 - z) * n + z * h


def layer_norm(x, scale, offset, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + offset


class Sparse:
    """A sparse matrix on the device as (rows, cols, vals); ``@`` x is a
    gather and a sum into the rows, differentiable in x."""

    def __init__(self, mat, device):
        coo = mat.tocoo()
        self.n = coo.shape[0]
        self.nnz = int(coo.nnz)
        self.rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
        self.cols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
        self.vals = torch.from_numpy(coo.data.astype(np.float32)).to(device)

    def __matmul__(self, x):
        out = x.new_zeros(self.n, x.shape[1])
        return out.index_add(0, self.rows, x[self.cols] * self.vals[:, None])


def relu(x):
    return F.relu(x)


def init_params(spec, seed, device):
    """The parameters of ``spec`` [(name, shape, kind, bound)] drawn from
    one generator on ``device`` seeded ``seed``: one uniform draw for every
    "uniform" leaf, U(-bound, bound); "ones" and "zeros" leaves are
    constant.  Returns {name: float32 tensor}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [int(np.prod(shape)) for _, shape, kind, _ in spec
             if kind == "uniform"]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, bound in spec:
        if kind == "uniform":
            n = int(np.prod(shape))
            out[name] = (flat[at:at + n].view(shape) * 2 - 1) * bound
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: kind {kind!r}")
    return out


def gru_spec(prefix, d_in, hidden):
    b = 1.0 / np.sqrt(hidden)
    return [(f"{prefix}.w_ih", (3 * hidden, d_in), "uniform", b),
            (f"{prefix}.w_hh", (3 * hidden, hidden), "uniform", b),
            (f"{prefix}.b_ih", (3 * hidden,), "uniform", b),
            (f"{prefix}.b_hh", (3 * hidden,), "uniform", b)]


def norm_spec(prefix, dim):
    return [(f"{prefix}.scale", (dim,), "ones", None),
            (f"{prefix}.offset", (dim,), "zeros", None)]


def gru_params(params, prefix):
    return tuple(params[f"{prefix}.{k}"] for k in ("w_ih", "w_hh", "b_ih",
                                                   "b_hh"))


def gru_flops(n, d_in, hidden):
    """Forward FLOPs of one GRU step over n rows (its two GEMMs)."""
    return 2.0 * n * 3 * hidden * (d_in + hidden)
