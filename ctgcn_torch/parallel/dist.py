# coding: utf-8
"""The process group, the parts of a run and the collectives (the
counterpart of ``_maybe_init_distributed`` in ``ctgcn_tpu/main.py`` and of
the engine's ``_fetch`` / ``_is_primary``).

The port is multi-controller: ``torchrun`` starts one process a GPU and
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT.  Rank r
runs on ``cuda:LOCAL_RANK`` under NCCL, or on the CPU under gloo when the
run asks for the CPU.  Without WORLD_SIZE in the environment the run is one
process and nothing is initialized, as the JAX package runs without
``JAX_COORDINATOR_ADDRESS``.

A run splits into ``Parts``: P parts on ranks 0..P-1 (the whole group, or a
subgroup of its first P ranks when P is smaller); a rank past P holds no
part.  One part in one process has no group: its collectives are local.

The collectives carry the gradients of the two ways a partitioned forward
uses them:
  * ``gather_own``: an all-gather after which every part computes the same
    loss from the whole tensor.  Every part's gradient of that tensor is
    then already whole, so the backward takes the part's own slice; a
    reduce-scatter of the sum would be P times too large.
  * ``gather_summed``: an all-gather whose outputs feed parts' own rows
    only (the all-gather SpMM); the backward sums the parts' gradients.
  * ``start_exchange``: the halo's ``all_to_all_single``, started without
    waiting, so the local product runs while it is in flight;
  * ``ring_shift``: part r's tensors to part r + 1 mod P (the pipeline's
    carry hand-off), one ``all_to_all_single`` a call; the backward ships
    the gradient back to part r - 1 mod P.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import types

import torch
import torch.distributed as dist

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def init_from_env(device, init_method="env://", timeout=TIMEOUT):
    """Join the process group that torchrun's environment describes: NCCL
    for a CUDA device (which becomes the process's current device), gloo
    for the CPU.  Returns True when this call initialized the group (the
    caller destroys it), False when there is nothing to do: no WORLD_SIZE
    in the environment, or a group already initialized on the backend
    ``device`` needs.  A failed initialization raises; the run never goes
    on as one process in its place."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", the device {device} needs {backend}")
        return False
    if "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary():
    """Whether this process writes the run's files (rank 0)."""
    return rank() == 0


def barrier():
    """Every rank of the group meets here (nothing in one process)."""
    if dist.is_initialized():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Parts:
    """P parts of a run: ``index`` is this process's part (None past P),
    ``group`` the process group of ranks 0..P-1 (None for one part in one
    process: its collectives are local)."""

    count: int
    index: int | None
    group: object = None

    @property
    def local(self) -> bool:
        return self.group is None


def make_parts(count, groups=None):
    """``count`` parts on ranks 0..count-1.  Every rank must call this with
    the same count (a smaller count makes a subgroup, which every rank
    joins); ``groups`` (a dict the caller keeps) caches the subgroups."""
    if not dist.is_initialized():
        if count != 1:
            raise ValueError(f"{count} parts need a process group of "
                             f"{count} ranks; this is one process")
        return Parts(1, 0)
    world = dist.get_world_size()
    if not 1 <= count <= world:
        raise ValueError(f"{count} parts over {world} ranks")
    if count == world:
        group = dist.group.WORLD
    else:
        groups = {} if groups is None else groups
        if count not in groups:
            groups[count] = dist.new_group(list(range(count)))
        group = groups[count]
    r = dist.get_rank()
    return Parts(count, r if r < count else None, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, parts, summed):
        ctx.parts, ctx.n, ctx.summed = parts, x.shape[0], summed
        bufs = [torch.empty_like(x) for _ in range(parts.count)]
        dist.all_gather(bufs, x.contiguous(), group=parts.group)
        return torch.cat(bufs)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            # gloo has no reduce-scatter: sum the whole gradient, slice it
            g = g.contiguous()
            dist.all_reduce(g, group=ctx.parts.group)
        i = ctx.parts.index
        return g[i * ctx.n:(i + 1) * ctx.n], None, None


def gather_own(x, parts: Parts):
    """The parts' ``x`` concatenated along dim 0 (the same size on every
    part), in part order.  Backward: this part's slice of the gradient,
    for a loss that every part computes whole from the result."""
    return x if parts.local else _AllGather.apply(x, parts, False)


def gather_summed(x, parts: Parts):
    """The parts' ``x`` concatenated along dim 0.  Backward: the sum over
    the parts of their gradients, sliced, for outputs that each part uses
    in its own rows only."""
    return x if parts.local else _AllGather.apply(x, parts, True)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, parts, pending):
        ctx.save_for_backward(send)
        ctx.parts, ctx.n_rows = parts, x.shape[0]
        send_buf = x[send.reshape(-1)]
        recv = torch.empty_like(send_buf)
        pending.work = dist.all_to_all_single(recv, send_buf,
                                              group=parts.group,
                                              async_op=True)
        pending.send_buf = send_buf
        return recv

    @staticmethod
    def backward(ctx, g):
        (send,) = ctx.saved_tensors
        g = g.contiguous()
        g_send = torch.empty_like(g)
        dist.all_to_all_single(g_send, g, group=ctx.parts.group)
        dx = g.new_zeros(ctx.n_rows, g.shape[1])
        dx.index_add_(0, send.reshape(-1), g_send)
        return dx, None, None, None


def start_exchange(x, send, parts: Parts):
    """Start the halo exchange of x [rows, d]: part q ships the rows
    ``send[p]`` ([P, H] row ids of q's x) to part p.  Returns (recv, wait):
    recv is [P·H, d], its rows q·H .. q·H + H - 1 the rows part q shipped
    here, valid only after ``wait()``.  Backward: the reverse exchange of
    recv's gradient, added into the rows it was gathered from."""
    if parts.local:
        return x[send.reshape(-1)], lambda: None
    pending = types.SimpleNamespace()
    recv = _Exchange.apply(x, send, parts, pending)
    return recv, pending.work.wait


def part0_flag(flag, parts: Parts, device):
    """Part 0's bool ``flag`` on every part: a choice that the parts must
    make together (a collective)."""
    if parts.local:
        return flag
    buf = torch.tensor([int(flag)], device=device)
    dist.broadcast(buf, src=0, group=parts.group)
    return bool(buf.item())


def all_reduce_grads(params, parts: Parts, average=False):
    """Sum (or average) the parameters' gradients over the parts in one
    collective; a parameter without a gradient counts as zeros."""
    params = list(params)
    if parts.local or not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=parts.group)
    if average:
        flat /= parts.count
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


class _RingShift(torch.autograd.Function):
    """x [rows, d] of part r to part r + 1 mod P (backward: r - 1 mod P).
    ``anchor`` is a scalar that requires grad, so that every part records
    the node and runs its backward, whatever x requires: each call's
    collective then runs on every part, forward and backward alike."""

    @staticmethod
    def forward(ctx, anchor, x, parts):
        ctx.parts = parts
        return _shift(x.contiguous(), parts, 1)

    @staticmethod
    def backward(ctx, g):
        return None, _shift(g.contiguous(), ctx.parts, -1), None


def _shift(x, parts, step):
    """One ``all_to_all_single`` that ships all of x to part index + step
    and receives the same shape from part index - step (mod P)."""
    p, r = parts.count, parts.index
    n = x.shape[0]
    send = [n if q == (r + step) % p else 0 for q in range(p)]
    recv = [n if q == (r - step) % p else 0 for q in range(p)]
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, output_split_sizes=recv,
                           input_split_sizes=send, group=parts.group)
    ring_shift.calls += 1
    return out


def ring_shift(carry, parts: Parts, anchor):
    """The carry (a tensor [rows, d], or a tuple of them, LSTM's (h, c)) of
    part r, received by part r + 1 mod P: part r gets part r - 1's.  The
    tuple's tensors travel as one (concatenated along dim 1).  ``anchor``:
    a scalar that requires grad (``_RingShift``).  One part without a group
    returns the carry.  ``ring_shift.calls`` counts the collectives made,
    forward and backward."""
    if parts.local:
        return carry
    if not isinstance(carry, tuple):
        return _RingShift.apply(anchor, carry, parts)
    widths = [c.shape[1] for c in carry]
    out = _RingShift.apply(anchor, torch.cat(carry, dim=1), parts)
    return tuple(out.split(widths, dim=1))


ring_shift.calls = 0
