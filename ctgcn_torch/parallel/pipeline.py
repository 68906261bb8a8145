# coding: utf-8
"""Temporal pipeline parallelism for the snapshot axis (port of
``ctgcn_tpu/parallel/pipeline.py``; config ``temporal_pipeline``).

Part r of P is stage r: it owns the contiguous chunk [r·T/P, (r+1)·T/P) of
the window's timesteps.  The node axis is split into K microbatches, and
the RNN carry flows from stage to stage (``dist.ring_shift``) while the
stages work on different microbatches, GPipe's schedule over a recurrent
scan:

    tick:      0      1      2      3     ...
    stage 0:  mb0    mb1    mb2    mb3
    stage 1:         mb0    mb1    mb2
    stage 2:                mb0    mb1

With P stages and K microbatches every stage runs K + P - 1 ticks; the
bubble is (P - 1) / (P + K - 1).  Every stage makes the same collective
at every tick, idle or not, forward and backward.  The [T, N, d] hidden
bank of the RNN's inputs is never gathered: a stage holds [T/P, N, d].

The backward runs through autograd: each tick's ``ring_shift`` ships the
carry's gradient back a stage (``pipelined_rnn_scan`` says how the ticks'
collectives keep one order on every part).
"""
from __future__ import annotations

import torch

from ctgcn_torch.parallel.dist import Parts, gather_own, ring_shift


def _zero_carry(cell, rows, like):
    h = like.new_zeros(rows, cell.hidden_dim)
    return (h, like.new_zeros(rows, cell.hidden_dim)) if cell.is_lstm else h


def _scan_from(cell, carry, xs):
    """``ops.rnn.rnn_scan``'s steps over xs [t, B, in] from ``carry``:
    (outs [t, B, H], final carry)."""
    gi_all = cell.input_proj(xs)
    outs = []
    for t in range(xs.shape[0]):
        carry = cell.step_from_proj(carry, gi_all[t])
        outs.append(carry[0] if cell.is_lstm else carry)
    return torch.stack(outs), carry


def _flat(carry):
    return carry if isinstance(carry, tuple) else (carry,)


def _edge(dep, value):
    """``value``, with an autograd edge to ``dep`` whose gradient is 0."""
    return torch.where(dep.new_zeros((), dtype=torch.bool), dep, value)


def pipelined_rnn_scan(cell, xs_local, parts: Parts, n_microbatch):
    """A GRU / LSTM scan over time, pipelined over the parts.

    Args:
      cell: ``ops.rnn.GRUCell`` or ``LSTMCell`` (replicated on every part).
      xs_local: this stage's [T/P, N, d] inputs (its chunk of timesteps).
      n_microbatch: K, the microbatches of the node axis; K divides N.

    Returns this stage's [T/P, N, H] outputs: the rows of a plain
    ``rnn_scan`` over the whole [T, N, d] window.

    Every tick's shift reads the carry that the tick before received: an
    active stage scans from it, an idle one ships it on, and stage 0,
    which starts every microbatch from zeros, takes zeros with an edge to
    it.  The last tick's received carry is tied to the outputs.  So on
    every part each tick's shift lies on the backward's path, after the
    next tick's: every part makes the backward's collectives in the same
    order."""
    t_chunk, n, d = xs_local.shape
    p, stage, k = parts.count, parts.index, n_microbatch
    if n % k:
        raise ValueError(f"N={n} does not divide into {k} microbatches")
    nmb = n // k
    x_mb = xs_local.reshape(t_chunk, k, nmb, d)
    zero = _zero_carry(cell, nmb, xs_local)
    anchor = xs_local.new_zeros((), requires_grad=True)
    carry, ys = zero, [None] * k
    for tick in range(k + p - 1):
        mb = tick - stage
        if 0 <= mb < k:
            ys[mb], carry = _scan_from(cell, carry, x_mb[:, mb])
        carry = ring_shift(carry, parts, anchor)
        if stage == 0:
            carry = tuple(map(_edge, _flat(carry), _flat(zero)))
            carry = carry if cell.is_lstm else carry[0]
    out = torch.stack(ys, dim=1).reshape(t_chunk, n, -1)
    if torch.is_grad_enabled():
        for c in _flat(carry):
            out = out + _edge(c.sum(), out.new_zeros(()))
    return out


def pick_microbatch(n_nodes, n_stages, cap_factor=4):
    """The largest divisor of ``n_nodes`` at most ``cap_factor * n_stages``:
    enough microbatches to keep every stage busy without shrinking a
    tick's node tile below use.  K = 1 runs the stages one after another,
    and stays correct."""
    for k in range(min(cap_factor * n_stages, n_nodes), 0, -1):
        if n_nodes % k == 0:
            return k
    raise ValueError(f"n_nodes={n_nodes} must be positive")


def ctgcn_pipelined_forward(model, xs, pyramids, parts: Parts,
                            n_microbatch=None):
    """CTGCN's window forward with the time RNN pipelined over the parts:
    the part's own MLP + CDN stacks on its timesteps (``model`` holds only
    its slice of them, ``parallel.mesh.shard_time``; xs and ``pyramids``
    its [T/P] chunk), then ``pipelined_rnn_scan`` (K from
    ``pick_microbatch`` unless given) and the LayerNorm on the part's
    chunk, then the gather over T that feeds the loss.  The time RNN and
    the norm are used before the gather here: their gradients are summed
    over the parts (``mesh.Sharding``).  Returns [T, N, out], or (embs,
    trans) for 'S', on every part."""
    res = model.per_timestep(xs, pyramids)
    s_variant = model.model_type == "S"
    hx = res[0] if s_variant else res
    k = n_microbatch or pick_microbatch(hx.shape[1], parts.count)
    out = gather_own(model.norm(pipelined_rnn_scan(model.rnn, hx, parts, k)),
                     parts)
    return (out, gather_own(res[1], parts)) if s_variant else out
