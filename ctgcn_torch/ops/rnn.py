# coding: utf-8
"""GRU/LSTM cells, the masked ``rnn_scan``, and ``core_rnn_sum``: the
core-axis RNN sum with a hand-written backward (port of
``ctgcn_tpu/ops/rnn.py``).

Parameter layout and gate math follow ``torch.nn.GRU`` / ``nn.LSTM``
(w_ih [G*H, in], w_hh [G*H, H], b_ih, b_hh; GRU gates r, z, n; LSTM gates
i, f, g, o).  A masked step passes the carry through unchanged and emits
zeros, which equals removing the step when outputs are summed.

The T-batched window tail (``nn.core_models``, ``batch_window_tail``)
runs T snapshots' core axes as one: inputs [K, T, N, d], masks [K, T],
and, for CTGCN's per-timestep layers, the T cells' parameters stacked on
a leading axis (``CellStack``: w_ih [T, G*H, d], ...).  The cell math,
``rnn_scan`` and ``core_rnn_sum`` broadcast over that axis.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.training import profiling


class _CellMath:
    """GRU/LSTM math over ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``: 2-D
    weights, or T cells' stacked on a leading axis (inputs [..., T, N, d]).
    """

    GATES = 0

    @property
    def hidden_dim(self):
        return self.w_hh.shape[-1]

    @property
    def is_lstm(self):
        return self.GATES == 4

    def input_proj(self, x):
        """Input-to-hidden projection, hoistable out of the scan."""
        return _proj(x, self.w_ih, self.b_ih)

    def step_from_proj(self, carry, gi):
        H = self.hidden_dim
        if self.is_lstm:
            h, c = carry
            return _lstm_gates_step(gi + _proj(h, self.w_hh, self.b_hh), c,
                                    H)
        return _gru_step(gi, _proj(carry, self.w_hh, self.b_hh), carry, H)


def _proj(x, w, b):
    """``x @ w^T + b``; a stacked w [T, G, d] / b [T, G] meets x
    [..., T, N, d]."""
    return x @ w.mT + b.unsqueeze(-2)


class _Cell(_CellMath, nn.Module):

    def __init__(self, input_dim, hidden_dim, bias=True, generator=None):
        super().__init__()
        G = self.GATES * hidden_dim
        bound = 1.0 / math.sqrt(hidden_dim)

        def uniform(*shape):
            return nn.Parameter(
                (torch.rand(*shape, generator=generator) * 2 - 1) * bound)

        self.w_ih = uniform(G, input_dim)
        self.w_hh = uniform(G, hidden_dim)
        self.b_ih = uniform(G) if bias else nn.Parameter(torch.zeros(G))
        self.b_hh = uniform(G) if bias else nn.Parameter(torch.zeros(G))

    def forward(self, carry, x):
        return self.step_from_proj(carry, self.input_proj(x))


class GRUCell(_Cell):
    """GRU parameters, torch layout (gate order: reset, update, new)."""

    GATES = 3


class LSTMCell(_Cell):
    """LSTM parameters, torch layout (gate order: input, forget, cell,
    output)."""

    GATES = 4


class CellStack(_CellMath):
    """The parameters of T cells of one type stacked on a leading [T] axis
    (differentiable: gradients reach each cell), for the T-batched tail."""

    def __init__(self, cells):
        self.GATES = cells[0].GATES
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            setattr(self, name, torch.stack([getattr(c, name)
                                             for c in cells]))

    def __call__(self, carry, x):
        return self.step_from_proj(carry, self.input_proj(x))


def step_mask(m):
    """A step's mask (a scalar, or [T] for the T-batched tail) shaped to
    broadcast over its [..., N, H] rows."""
    return m[..., None, None]


def rnn_scan(cell, xs, mask=None):
    """Run a GRU/LSTM over the leading axis of ``xs`` ([T, B, in], or
    [K, T, N, in] for the T-batched tail) from a zero carry.

    mask: optional bool[T] ([K, T]); invalid steps pass the carry through
    and emit zeros.  Returns (outs [T, B, H], final carry)."""
    H = cell.hidden_dim
    h = xs.new_zeros(*xs.shape[1:-1], H)
    carry = (h, torch.zeros_like(h)) if cell.is_lstm else h
    gi_all = cell.input_proj(xs)
    outs = []
    for t in range(xs.shape[0]):
        new = cell.step_from_proj(carry, gi_all[t])
        if mask is not None:
            v = step_mask(mask[t].bool())
            if cell.is_lstm:
                new = tuple(torch.where(v, nw, old)
                            for nw, old in zip(new, carry))
            else:
                new = torch.where(v, new, carry)
        carry = new
        out = carry[0] if cell.is_lstm else carry
        outs.append(out if mask is None else torch.where(v, out, 0.0))
    return torch.stack(outs), carry


#: default byte gate of core_rnn_sum's K-batched mode (CVJP batch budget)
CVJP_BATCH_BUDGET = 512 << 20


def _batched(is_lstm, acc, H, batch_budget):
    """The K-batched mode when the [K, N, G*H] f32 gate stacks ([K, T, N,
    G*H] in the T-batched tail: the gate counts T) fit the budget; the
    lean per-step recompute above it."""
    return 4 * acc.shape[:-1].numel() * (4 if is_lstm else 3) * H \
        <= batch_budget


class _CoreRnnSum(torch.autograd.Function):
    """The core-axis RNN summed; its forward and its backward are each a
    ``core_rnn`` span while tracing is on."""

    @staticmethod
    def forward(ctx, *args):
        with profiling.span("core_rnn"):
            return _CoreRnnSum._forward(ctx, *args)

    @staticmethod
    def backward(ctx, g_out):
        with profiling.span("core_rnn"):
            return _CoreRnnSum._backward(ctx, g_out)

    @staticmethod
    def _forward(ctx, acc, valid, w_ih, w_hh, b_ih, b_hh, is_lstm,
                 batch_budget):
        K = acc.shape[0]
        H = w_hh.shape[-1]
        batched = _batched(is_lstm, acc, H, batch_budget)
        vmask = step_mask(valid)
        h = acc.new_zeros(*acc.shape[1:-1], H, dtype=torch.float32)
        c = torch.zeros_like(h)
        s = torch.zeros_like(h)
        saved_h = acc.new_empty(*acc.shape[:-1], H)
        saved_c = acc.new_empty(*acc.shape[:-1], H) if is_lstm else None
        if batched:
            # one [K, N, d] GEMM hoisted out of the sequential loop
            gi_all = _proj(F.relu(acc.float()) * vmask, w_ih, b_ih)
        for k in range(K):
            v = vmask[k]
            vb = v > 0
            gi = (gi_all[k] if batched
                  else _proj(F.relu(acc[k].float()) * v, w_ih, b_ih))
            saved_h[k] = h
            gh = _proj(h, w_hh, b_hh)
            if is_lstm:
                saved_c[k] = c
                h_new, c_new = _lstm_gates_step(gi + gh, c, H)
                c = torch.where(vb, c_new, c)
            else:
                h_new = _gru_step(gi, gh, h, H)
            h = torch.where(vb, h_new, h)
            s = s + torch.where(vb, h, 0.0)
        ctx.save_for_backward(acc, valid, w_ih, w_hh, b_ih, b_hh, saved_h,
                              *(() if saved_c is None else (saved_c,)))
        ctx.is_lstm = is_lstm
        ctx.batched = batched
        return s

    @staticmethod
    def _backward(ctx, g_out):
        acc, valid, w_ih, w_hh, b_ih, b_hh, saved_h, *rest = \
            ctx.saved_tensors
        p = (w_ih, w_hh, b_ih, b_hh)
        g_out = g_out.float()
        if ctx.batched:
            grads = _bwd_batched(p, acc, valid, saved_h,
                                 rest[0] if ctx.is_lstm else None, g_out)
        else:
            grads = _bwd_lean(p, acc, valid, saved_h,
                              rest[0] if ctx.is_lstm else None, g_out)
        d_acc, gw_ih, gw_hh, gb_ih, gb_hh = grads
        return d_acc, None, gw_ih, gw_hh, gb_ih, gb_hh, None, None


def _gru_step(gi, gh, h, H):
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def _lstm_gates_step(gates, c, H):
    i = torch.sigmoid(gates[..., :H])
    f = torch.sigmoid(gates[..., H:2 * H])
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = torch.sigmoid(gates[..., 3 * H:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _bwd_batched(p, acc, valid, saved_h, saved_c, g_out):
    """K-batched backward: gates for all slots as batched GEMMs; the
    reverse loop's sequential chain is one d_gates @ w_hh GEMM per step."""
    w_ih, w_hh, b_ih, b_hh = p
    K = acc.shape[0]
    H = w_hh.shape[-1]
    vmask = step_mask(valid)
    acc_f = acc.float()
    hx_all = F.relu(acc_f) * vmask
    gi_all = _proj(hx_all, w_ih, b_ih)
    h_prevs = saved_h.float()
    dh = torch.zeros_like(g_out)
    if saved_c is not None:
        c_prevs = saved_c.float()
        gates = gi_all + _proj(h_prevs, w_hh, b_hh)
        i = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        tc = torch.tanh(f * c_prevs + i * g)
        dc = torch.zeros_like(dh)
        d_gates = g_out.new_empty(*acc.shape[:-1], 4 * H)
        for k in reversed(range(K)):
            vb = vmask[k] > 0
            dh_in = dh + torch.where(vb, g_out, 0.0)
            do = dh_in * tc[k]
            dc_tot = dc + dh_in * o[k] * (1.0 - tc[k] * tc[k])
            dg_k = torch.cat([
                dc_tot * g[k] * i[k] * (1.0 - i[k]),
                dc_tot * c_prevs[k] * f[k] * (1.0 - f[k]),
                dc_tot * i[k] * (1.0 - g[k] * g[k]),
                do * o[k] * (1.0 - o[k])], dim=-1)
            dg_k = torch.where(vb, dg_k, 0.0)
            dh = torch.where(vb, dg_k @ w_hh, dh_in)
            dc = torch.where(vb, dc_tot * f[k], dc)
            d_gates[k] = dg_k
        d_gi = d_gh = d_gates
    else:
        gh_all = _proj(h_prevs, w_hh, b_hh)
        r = torch.sigmoid(gi_all[..., :H] + gh_all[..., :H])
        z = torch.sigmoid(gi_all[..., H:2 * H] + gh_all[..., H:2 * H])
        hn = gh_all[..., 2 * H:]
        nn_ = torch.tanh(gi_all[..., 2 * H:] + r * hn)
        d_gi = g_out.new_empty(*acc.shape[:-1], 3 * H)
        d_gh = g_out.new_empty(*acc.shape[:-1], 3 * H)
        for k in reversed(range(K)):
            vb = vmask[k] > 0
            dh_in = dh + torch.where(vb, g_out, 0.0)
            dn = dh_in * (1.0 - z[k])
            dz = dh_in * (h_prevs[k] - nn_[k])
            da_n = dn * (1.0 - nn_[k] * nn_[k])
            da_r = da_n * hn[k] * r[k] * (1.0 - r[k])
            da_z = dz * z[k] * (1.0 - z[k])
            d_gi_k = torch.where(vb, torch.cat([da_r, da_z, da_n], -1), 0.0)
            d_gh_k = torch.where(
                vb, torch.cat([da_r, da_z, da_n * r[k]], -1), 0.0)
            dh = torch.where(vb, dh_in * z[k] + d_gh_k @ w_hh, dh_in)
            d_gi[k] = d_gi_k
            d_gh[k] = d_gh_k
    d_acc = (((d_gi @ w_ih) * vmask) * (acc_f > 0)).to(acc.dtype)
    return (d_acc,
            torch.einsum("k...ng,k...nd->...gd", d_gi, hx_all),
            torch.einsum("k...ng,k...nh->...gh", d_gh, h_prevs),
            d_gi.sum(dim=(0, -2)), d_gh.sum(dim=(0, -2)))


def _bwd_lean(p, acc, valid, saved_h, saved_c, g_out):
    """Lean backward: each reverse step recomputes its gates from the saved
    pre-step carry; nothing of size [K, N, G*H] is materialized."""
    w_ih, w_hh, b_ih, b_hh = p
    K = acc.shape[0]
    H = w_hh.shape[-1]
    vmask = step_mask(valid)
    dh = torch.zeros_like(g_out)
    dc = torch.zeros_like(dh)
    gw_ih, gw_hh = torch.zeros_like(w_ih), torch.zeros_like(w_hh)
    gb_ih, gb_hh = torch.zeros_like(b_ih), torch.zeros_like(b_hh)
    d_acc = torch.empty_like(acc)
    for k in reversed(range(K)):
        v = vmask[k]
        vb = v > 0
        dh_in = dh + torch.where(vb, g_out, 0.0)
        acc_f = acc[k].float()
        hx = F.relu(acc_f) * v
        gi = _proj(hx, w_ih, b_ih)
        h_prev = saved_h[k].float()
        if saved_c is not None:
            c_prev = saved_c[k].float()
            gates = gi + _proj(h_prev, w_hh, b_hh)
            i = torch.sigmoid(gates[..., :H])
            f = torch.sigmoid(gates[..., H:2 * H])
            g = torch.tanh(gates[..., 2 * H:3 * H])
            o = torch.sigmoid(gates[..., 3 * H:])
            tc = torch.tanh(f * c_prev + i * g)
            do = dh_in * tc
            dc_tot = dc + dh_in * o * (1.0 - tc * tc)
            d_gates = torch.where(vb, torch.cat([
                dc_tot * g * i * (1.0 - i), dc_tot * c_prev * f * (1.0 - f),
                dc_tot * i * (1.0 - g * g), do * o * (1.0 - o)], -1), 0.0)
            dh = torch.where(vb, d_gates @ w_hh, dh_in)
            dc = torch.where(vb, dc_tot * f, dc)
            d_gi = d_gh = d_gates
        else:
            gh = _proj(h_prev, w_hh, b_hh)
            r = torch.sigmoid(gi[..., :H] + gh[..., :H])
            z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
            h_n = gh[..., 2 * H:]
            nn_ = torch.tanh(gi[..., 2 * H:] + r * h_n)
            dn = dh_in * (1.0 - z)
            dz = dh_in * (h_prev - nn_)
            da_n = dn * (1.0 - nn_ * nn_)
            da_r = da_n * h_n * r * (1.0 - r)
            da_z = dz * z * (1.0 - z)
            d_gi = torch.where(vb, torch.cat([da_r, da_z, da_n], -1), 0.0)
            d_gh = torch.where(vb, torch.cat([da_r, da_z, da_n * r], -1),
                               0.0)
            dh = torch.where(vb, dh_in * z + d_gh @ w_hh, dh_in)
        d_acc[k] = ((d_gi @ w_ih) * v) * (acc_f > 0)
        gw_ih += d_gi.mT @ hx
        gw_hh += d_gh.mT @ h_prev
        gb_ih += d_gi.sum(dim=-2)
        gb_hh += d_gh.sum(dim=-2)
    return d_acc, gw_ih, gw_hh, gb_ih, gb_hh


def core_rnn_sum(cell, acc, valid, batch_budget=CVJP_BATCH_BUDGET,
                 kept=None):
    """Masked core-axis RNN returning the SUM of the per-step hidden states:
    ``rnn_scan(cell, relu(acc) * valid, mask=valid)[0].sum(0)`` as one op
    whose backward saves only ``acc`` and the [K, N, H] pre-step carries
    (stored in ``acc.dtype``) and runs one reverse pass.

    Args:
      cell: GRUCell, LSTMCell, or (T-batched) a ``CellStack`` of T cells.
      acc: [K, N, d] prefix accumulation; [K, T, N, d] for the T-batched
        tail, whose one cell (CGCN's) or T stacked cells (CTGCN's) run
        every snapshot at once.
      valid: float32[K] mask (1.0 = valid slot); [K, T] T-batched.
      batch_budget: byte gate of the K-batched mode (gate stacks of
        [K, N, G*H] f32, times T batched, at most this size); above it
        the lean mode.
      kept: the valid slots' count as the host built them (summed over
        T), counted into ``core_rnn.valid_slot_steps`` beside the K (times
        T) slots of ``core_rnn.slot_steps``; None counts the latter alone.
    Returns float32 [N, H] ([T, N, H]).
    """
    profiling.count("core_rnn.slot_steps", acc.shape[:-2].numel())
    if kept is not None:
        profiling.count("core_rnn.valid_slot_steps", kept)
    p = (cell.w_ih, cell.w_hh, cell.b_ih, cell.b_hh)
    if acc.dim() == 4 and cell.w_ih.dim() == 2:
        # one cell shared by the T snapshots (CGCN): its gradient sums
        # theirs
        p = tuple(w.expand(acc.shape[1], *w.shape) for w in p)
    return _CoreRnnSum.apply(acc, valid.float(), *p, cell.is_lstm,
                             int(batch_budget))
