# coding: utf-8
"""The CTGCN family with the k-core diffusion layers (port of
``ctgcn_tpu/nn/core_models.py``).

  * CoreDiffusion: the K slot products ``A_k @ x`` of a core pyramid on
    its backend (``slot_products``: principal blocks, dense bank, ELL/CSR
    plans, BSR plans or COO; see ``ops/pyramid.py``), masked by ``valid``;
    their prefix sum over the core axis goes through ReLU and a masked
    GRU/LSTM whose outputs are summed (``ops.rnn.core_rnn_sum``), then
    LayerNorm.  Given the host's count of kept slots (``CorePyramid.kept``),
    the stages after the products run over those slots alone.
    Delta-encoded ELL slots take a second prefix sum and the +I back as
    "+ x"; the blocks backend runs in core-sorted node order and
    un-permutes after the LayerNorm.
  * CGCN shares one MLP + CDN across the snapshots; CTGCN keeps
    per-timestep distinct MLP + CDN parameters, then runs one RNN over the
    time axis and a LayerNorm.  The 'S' variants also return the MLP
    output, the structure embedding of the reconstruction loss.
  * Identity node features (x = I, input_dim = N) are never materialized:
    ``xs=None`` makes each first Linear return its weight.

The bank's precision (the config's ``matmul_precision``) follows the JAX
package: a bf16 bank or bf16 blocks multiply bf16 operands into f32
results; ``dense_prec: "high"`` on an f32 bank runs three TF32 GEMMs over a
hi/lo split (the H100's counterpart of the TPU's bf16_3x); bf16 ELL plans
store the slot products in bf16, and above ``core_rnn_budget`` the prefix
too.

Memory knobs are constructor arguments with ``ctgcn_tpu``'s defaults
(the JAX package reads them from ``CTGCN_TPU_*`` variables; the driver
here reads the same variables once and passes them in):
``act_budget`` (window activation bytes above which the backward
recomputes each timestep's forward, ``torch.utils.checkpoint``),
``remat_policy`` ("full": the whole timestep; "save_spmm": only the
stages between the SpMMs, keeping the slot products), ``layer_remat``
(checkpoint each CoreDiffusion layer), ``cvjp_batch_budget`` (the
K-batched mode gate of ``core_rnn_sum``), ``core_rnn_budget`` (the bf16
prefix gate and the scan tails' gate), ``core_vjp`` and
``acc_materialize_budget`` (with ``core_vjp=False``, or a prefix above the
budget, the tail runs as a masked scan: ``rnn_scan`` under
``core_rnn_budget``, above it a per-step checkpointed scan over the
prefix, or with the prefix above the budget the fused running sums), and
``batch_window_tail`` (on the blocks backend, each layer's tail runs the
T snapshots at once: ``CoreDiffusion.tail`` on [K, T, N, d]).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ctgcn_torch.nn.layers import MLP, LayerNorm, TimeRule, layer_norm
from ctgcn_torch.ops.bsr_spmm import pyramid_spmm
from ctgcn_torch.ops.ell import ell_spmm
from ctgcn_torch.ops.pyramid import CorePyramid, pyramid_at
from ctgcn_torch.ops.rnn import (
    CVJP_BATCH_BUDGET, CellStack, GRUCell, LSTMCell, core_rnn_sum, rnn_scan,
    step_mask)

#: default window activation budget (bytes) before per-timestep remat
ACT_BUDGET = 4 << 30
#: default budget (bytes) of one CoreDiffusion tail above which bf16 slot
#: products store the prefix in bf16 too (``_core_rnn_budget_bytes``)
CORE_RNN_BUDGET = 512 << 20
#: default bytes of the prefix above which the tail does not materialize
#: it (``_acc_materialize_budget_bytes``)
ACC_MATERIALIZE_BUDGET = 8 << 30
#: the over-budget recompute policies (``_remat``)
REMAT_POLICIES = ("full", "save_spmm")


def _make_rnn(rnn_type, input_dim, hidden_dim, bias, generator):
    if rnn_type not in ("GRU", "LSTM"):
        raise ValueError(f"rnn_type {rnn_type!r}")
    cls = GRUCell if rnn_type == "GRU" else LSTMCell
    return cls(input_dim, hidden_dim, bias=bias, generator=generator)


class _Bf16MM(torch.autograd.Function):
    """``a @ b`` for a constant bf16 ``a`` and bf16 ``b``, f32 result (the
    JAX package's bf16 dot with ``preferred_element_type=f32``).  On the
    card a bf16 tensor-core GEMM with f32 output; elsewhere the operands
    are upcast, which is exact (a bf16 product fits an f32).  The backward
    gives ``a^T g`` (f32 sums) in bf16, b's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return None, (a.float().T @ g.float()).to(a.dtype)


@contextlib.contextmanager
def _tf32_matmuls():
    """TF32 for the GEMMs inside only; the flag is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tf32_split(t):
    """(hi, lo): hi is t with its mantissa cut to TF32's 10 bits (exact in
    TF32), lo = t - hi (exact in f32)."""
    hi = (t.view(torch.int32) & -8192).view(torch.float32)
    return hi, t - hi


def _mm_3xtf32(a, b):
    """``a @ b`` in f32 from three TF32 GEMMs over hi/lo splits
    (``hi·hi + (hi·lo + lo·hi)``): the H100's counterpart of the TPU's
    bf16_3x (``Precision.HIGH``), about 2^-21 relative error per product
    (the dropped lo·lo term and TF32's rounding of lo)."""
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    with _tf32_matmuls():
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


class _HighMM(torch.autograd.Function):
    """``a @ b`` by ``_mm_3xtf32`` for a constant f32 ``a``; the backward
    ``a^T g`` runs the same way (JAX's HIGH dot transposes at HIGH)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a)
        return _mm_3xtf32(a, b)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return None, _mm_3xtf32(a.T, g)


def _bank_mm(a, b, prec):
    """One bank GEMM ``a @ b`` (f32 result) at the bank's precision: bf16
    operands for a bf16 bank, else 3xTF32 ("high") or full f32."""
    if a.dtype == torch.bfloat16:
        return _Bf16MM.apply(a, b.bfloat16())
    if prec == "high":
        return _HighMM.apply(a, b)
    return a @ b


def slot_products(x, pyramid: CorePyramid):
    """The K per-slot SpMM products [K, N, d] (+I folded in unless the
    slots are delta-encoded, valid-masked) and ``xp``, the input in the
    backend's node order (the counterpart of ``CoreDiffusion._contribs``).

    f32, except on bf16 ELL plans, whose products are stored in bf16.  The
    bank GEMMs (blocks, dense) run at the bank's precision (``_bank_mm``):
    full f32 by default (no TF32), the JAX package's ``Precision.HIGHEST``.
    """
    n, K = pyramid.n_nodes, pyramid.num_slots
    backend = pyramid.backend
    xp = x
    if backend == "blocks":
        # core-sorted principal blocks: slot k's adjacency is the leading
        # nb_k x nb_k block; the node-wise stages after the products are
        # permutation-equivariant, so the layer runs in that order
        xp = x[pyramid.perm]
        parts = []
        for k in range(K):
            if k < len(pyramid.blocks):
                blk = pyramid.blocks[k]
                nb = blk.shape[0]
                r = F.pad(_bank_mm(blk, xp[:nb], pyramid.dense_prec),
                          (0, 0, 0, n - nb))
            else:
                r = xp.new_zeros(n, x.shape[1])
            # the +I on the max-core slot, as "+ x"
            parts.append(r + xp if k == 0 else r)
        contribs = torch.stack(parts)
    elif backend == "dense":
        if pyramid.dense.dtype == torch.float32 \
                and pyramid.dense_prec == "highest":
            contribs = torch.matmul(pyramid.dense, x)
        else:
            contribs = torch.stack([
                _bank_mm(pyramid.dense[k], x, pyramid.dense_prec)
                for k in range(K)])
    elif backend == "ell":
        contribs = ell_spmm(pyramid.ell_fwd, pyramid.ell_t, x,
                            bf16=pyramid.ell_bf16).reshape(K, n, -1)
    elif backend == "pallas":
        contribs = pyramid_spmm(pyramid.plan_fwd, pyramid.plan_t, x, K, n)
    else:
        # one flattened gather and index_add over all K slots
        offsets = (torch.arange(K, device=x.device) * n)[:, None]
        gathered = (x[pyramid.cols.reshape(-1)]
                    * pyramid.vals.reshape(-1)[:, None])
        contribs = x.new_zeros(K * n, x.shape[1]).index_add(
            0, (pyramid.rows + offsets).reshape(-1), gathered).reshape(
                K, n, -1)
    return contribs * pyramid.valid.to(contribs.dtype)[:, None, None], xp


def _tail_bytes(K, n, d_in, hidden, is_lstm, t_batch=1):
    """A tail's estimated footprint, 4·K·N·(2·d_in + per_h·H) bytes (per_h
    7 for a GRU, 9 for an LSTM), times the T snapshots of the T-batched
    tail."""
    return 4 * K * n * (2 * d_in + (9 if is_lstm else 7) * hidden) * t_batch


def acc_in_bf16(contribs_dtype, K, n, d_in, hidden, is_lstm,
                budget=CORE_RNN_BUDGET):
    """Whether a CoreDiffusion layer stores its [K, N, d_in] prefix in
    bf16 before the core-axis RNN: when the slot products are bf16 and the
    tail's footprint (``_tail_bytes``) exceeds ``budget`` (JAX ``_tail``,
    ``ctgcn_tpu/nn/core_models.py:369-397``)."""
    return (contribs_dtype == torch.bfloat16
            and _tail_bytes(K, n, d_in, hidden, is_lstm) > budget)


def _prefix_acc(contribs, delta, xp):
    """The k-core prefix in f32 (the JAX package's ``_prefix_acc``, a
    lower-triangular matmul there); delta slots hold A_k - A_{k-1}, so the
    slot products are themselves a prefix: (L L) @ contribs + x."""
    acc = torch.cumsum(contribs.float(), dim=0)
    if delta:
        acc = torch.cumsum(acc, dim=0) + xp
    return acc


def _scan_step(cell, carry, hx, vb):
    """One masked core-axis RNN step on ``hx``: (new carry, output); an
    invalid slot passes the carry and outputs zeros."""
    new = cell.step_from_proj(carry, cell.input_proj(hx))
    if cell.is_lstm:
        new = tuple(torch.where(vb, nw, old) for nw, old in zip(new, carry))
        return new, torch.where(vb, new[0], 0.0)
    new = torch.where(vb, new, carry)
    return new, torch.where(vb, new, 0.0)


def _zero_carry(cell, like):
    h = like.new_zeros(*like.shape[:-1], cell.hidden_dim,
                       dtype=torch.float32)
    return (h, h) if cell.is_lstm else h


def _acc_step(cell, carry, acc_k, v):
    return _scan_step(cell, carry, F.relu(acc_k.float()) * v, v > 0)


def _core_rnn_scan_acc(cell, acc, valid):
    """The over-budget scan tail over a materialized prefix ``acc`` [K,
    N, d] (JAX ``_core_rnn_scan_acc``): ReLU, mask and one RNN step a
    slot, each step checkpointed, so the backward keeps ``acc`` and the
    carries between steps.  Returns the outputs [K, N, H]."""
    carry, outs = _zero_carry(cell, acc[0]), []
    for k in range(acc.shape[0]):
        carry, out = checkpoint(_acc_step, cell, carry, acc[k],
                                step_mask(valid[k].float()),
                                use_reentrant=False)
        outs.append(out)
    return torch.stack(outs)


def _fused_step(cell, carry, s, acc, c_k, v):
    s = s + c_k.float()
    if acc is not None:
        acc = acc + s
    carry, out = _scan_step(cell, carry,
                            F.relu(s if acc is None else acc) * v, v > 0)
    return carry, s, acc, out


def _core_rnn_scan_remat(cell, contribs, valid, delta=False, xp=None):
    """The fused-prefix scan tail (JAX ``_core_rnn_scan_remat``, reached
    when the prefix is over ``acc_materialize_budget``): the prefix sums
    run inside the checkpointed steps, s_k = s_{k-1} + c_k, and for delta
    slots a second sum acc_k = acc_{k-1} + s_k from acc = ``xp`` (the +I
    of slot 0), so no [K, N, d] prefix is kept; an invalid slot's c_k = 0
    passes both sums.  Returns the outputs [K, N, H]."""
    carry, outs = _zero_carry(cell, contribs[0]), []
    s = contribs.new_zeros(contribs.shape[1:], dtype=torch.float32)
    acc = xp.float() if delta else None
    for k in range(contribs.shape[0]):
        carry, s, acc, out = checkpoint(
            _fused_step, cell, carry, s, acc, contribs[k],
            step_mask(valid[k].float()), use_reentrant=False)
        outs.append(out)
    return torch.stack(outs)


def _maybe_checkpoint(fn, *args, enabled):
    return (checkpoint(fn, *args, use_reentrant=False) if enabled
            else fn(*args))


class CoreDiffusion(nn.Module):
    """K-core diffusion layer: h_k = h_{k-1} + A_k @ x over the valid core
    slots (max core first), ReLU, a core-axis RNN whose outputs are summed,
    then LayerNorm."""

    def __init__(self, input_dim, output_dim, bias=True, rnn_type="GRU",
                 generator=None, cvjp_batch_budget=CVJP_BATCH_BUDGET,
                 core_rnn_budget=CORE_RNN_BUDGET, core_vjp=True,
                 acc_materialize_budget=ACC_MATERIALIZE_BUDGET):
        super().__init__()
        self.rnn = _make_rnn(rnn_type, input_dim, output_dim, bias, generator)
        self.norm = LayerNorm(output_dim)
        self.cvjp_batch_budget = cvjp_batch_budget
        self.core_rnn_budget = core_rnn_budget
        self.core_vjp = core_vjp
        self.acc_materialize_budget = acc_materialize_budget

    def forward(self, x, pyramid: CorePyramid, save_spmm=False):
        """``save_spmm``: checkpoint the tail alone, whose saved input is
        the slot products, so the backward recomputes the tail and no
        SpMM."""
        contribs, xp = slot_products(x.float(), pyramid)
        delta = pyramid.backend == "ell" and pyramid.ell_delta
        out = _maybe_checkpoint(
            functools.partial(self.tail, kept=pyramid.kept), contribs,
            pyramid.valid, delta, xp if delta else None, enabled=save_spmm)
        if pyramid.backend == "blocks":
            out = out[pyramid.inv_perm]
        return out

    def tail(self, contribs, valid, delta, xp, cell=None, norm=None,
             budget=None, kept=None):
        """Prefix, ReLU, the core-axis RNN summed, LayerNorm (JAX
        ``_tail``): slot products [K, N, d] (``valid`` [K]) -> [N, H].

        The T-batched window tail passes [K, T, N, d] (``valid`` [K, T])
        -> [T, N, H], with ``cell`` and ``norm`` the T timesteps' stacked
        ones (CTGCN; CGCN's layer runs its own) and ``budget`` the window's
        activation budget, which gates its footprint in place of
        ``core_rnn_budget``.  ``kept``: the valid slots' host count (a
        tuple of T for the T-batched tail), or None.

        The host packs the kept cores into the leading slots, so the empty
        ones are a suffix: with ``kept`` the tail runs only the first
        ``kept`` slots (T-batched: the most any snapshot keeps), whose
        prefix does not read the others; the gates below read the bank's
        K all the same."""
        cell = self.rnn if cell is None else cell
        norm = self.norm if norm is None else norm
        budget = self.core_rnn_budget if budget is None else budget
        K, n, d_in = contribs.shape[0], contribs.shape[-2], contribs.shape[-1]
        t_batch = contribs.shape[1:-2].numel()
        over = _tail_bytes(K, n, d_in, cell.hidden_dim, cell.is_lstm,
                           t_batch) > budget
        bf16 = contribs.dtype == torch.bfloat16
        materialize = (contribs.element_size() * contribs.numel()
                       <= self.acc_materialize_budget)
        if kept is not None:
            counts = (kept,) if isinstance(kept, int) else kept
            steps = max(1, *counts)
            contribs, valid = contribs[:steps], valid[:steps]
            kept = sum(counts)
        if self.core_vjp and materialize:
            # the hand-written backward: saves acc (bf16 when the bf16
            # products' tail is over budget) and the pre-step carries
            acc = _prefix_acc(contribs, delta, xp)
            if bf16 and over:
                acc = acc.bfloat16()
            return norm(core_rnn_sum(cell, acc, valid.float(),
                                     self.cvjp_batch_budget, kept=kept,
                                     slots=K))
        if over and materialize:
            acc = _prefix_acc(contribs, delta, xp)
            outs = _core_rnn_scan_acc(cell, acc.bfloat16() if bf16 else acc,
                                      valid)
        elif over:
            outs = _core_rnn_scan_remat(cell, contribs, valid, delta, xp)
        else:
            acc = _prefix_acc(contribs, delta, xp)
            outs, _ = rnn_scan(cell, F.relu(acc) * step_mask(valid.float()),
                               mask=valid)
        return norm(outs.sum(0))


class CDN(nn.Module):
    """A stack of CoreDiffusion layers."""

    def __init__(self, input_dim, hidden_dim, output_dim, diffusion_num,
                 bias=True, rnn_type="GRU", generator=None, layer_remat=False,
                 **layer_kw):
        super().__init__()
        if diffusion_num < 1:
            raise ValueError("diffusion_num must be >= 1")
        if diffusion_num == 1:
            dims = [(input_dim, output_dim)]
        else:
            dims = ([(input_dim, hidden_dim)]
                    + [(hidden_dim, hidden_dim)] * (diffusion_num - 2)
                    + [(hidden_dim, output_dim)])
        self.layers = nn.ModuleList(
            CoreDiffusion(d_in, d_out, bias=bias, rnn_type=rnn_type,
                          generator=generator, **layer_kw)
            for d_in, d_out in dims)
        self.layer_remat = layer_remat

    def forward(self, x, pyramid, save_spmm=False):
        """``save_spmm``: each layer checkpoints its tail apart from its
        products (``CoreDiffusion.forward``), which bounds a layer's
        residuals as ``layer_remat``'s whole-layer checkpoint would."""
        for layer in self.layers:
            if self.layer_remat and torch.is_grad_enabled() and not save_spmm:
                x = checkpoint(layer, x, pyramid, use_reentrant=False)
            else:
                x = layer(x, pyramid, save_spmm)
        return x


def _window_act_bytes(cdn: CDN, pyramids: CorePyramid):
    """Rough forward-activation footprint of the window: the [K, N, d_in]
    contribs/prefix/relu plus [K, N, 3H+H] GRU tensors per layer."""
    T, K = pyramids.valid.shape
    per_node = sum(3 * layer.rnn.w_ih.shape[-1] + 4 * layer.rnn.w_hh.shape[-1]
                   for layer in cdn.layers)
    return 4 * T * K * pyramids.n_nodes * per_node


def _over_window(step, xs, pyramids: CorePyramid, cdn: CDN, act_budget,
                 remat_policy="full"):
    """``step(t, x_t, pyramid_t, save_spmm)`` for every snapshot of the
    window (x_t None for identity features).  Above the activation budget
    the backward recomputes each snapshot's forward: under "full" the
    whole step (one checkpoint a snapshot), so the backward holds one
    snapshot at a time; under "save_spmm" the stages between the SpMMs
    (the MLP and each layer's tail, ``save_spmm=True``), whose checkpoints
    keep the slot products, so no SpMM runs twice.  Returns the list of
    step outputs."""
    T = pyramids.valid.shape[0]
    remat = (torch.is_grad_enabled()
             and _window_act_bytes(cdn, pyramids) > act_budget)
    save_spmm = remat and remat_policy == "save_spmm"
    outs = []
    for t in range(T):
        def per_t(x, t=t):
            return step(t, x, pyramid_at(pyramids, t), save_spmm)

        x = None if xs is None else xs[t]
        outs.append(_maybe_checkpoint(per_t, x,
                                      enabled=remat and not save_spmm))
    return outs


def _window_tail(cdns, trans, pyramids: CorePyramid, act_budget):
    """All T snapshots of a blocks window through the CDN(s), each layer's
    tail batched across T (JAX ``_ragged_blocks_cdn_window``): the bank
    GEMMs stay per snapshot (each its own block shapes), then one
    ``CoreDiffusion.tail`` runs the T snapshots' [K, N, d] products as
    [K, T, N, d]: one K-step core-axis RNN a layer instead of T.

    ``cdns``: CGCN's shared CDN, or CTGCN's T CDNs, whose cells and norms
    run stacked (``CellStack``).  No timestep is recomputed in the
    backward and ``layer_remat`` is not read, as in the JAX package.
    Returns [T, N, out] in node order."""
    shared = isinstance(cdns, CDN)
    T = pyramids.valid.shape[0]
    h = trans
    for li, layer in enumerate((cdns if shared else cdns[0]).layers):
        contribs = torch.stack([
            slot_products(h[t].float(), pyramid_at(pyramids, t))[0]
            for t in range(T)], dim=1)
        cell = norm = None
        if not shared:
            layers = [cdn.layers[li] for cdn in cdns]
            cell = CellStack([lyr.rnn for lyr in layers])
            norm = functools.partial(
                layer_norm,
                scale=torch.stack([lyr.norm.scale for lyr in layers])[:, None],
                offset=torch.stack([lyr.norm.offset
                                    for lyr in layers])[:, None],
                eps=layer.norm.eps)
        out = layer.tail(contribs, pyramids.valid.T, False, None, cell=cell,
                         norm=norm, budget=act_budget if T > 1 else None,
                         kept=pyramids.kept)
        h = torch.take_along_dim(out, pyramids.inv_perm[:, :, None], dim=1)
    return h


def _run_mlp(mlp, x, save_spmm):
    return _maybe_checkpoint(mlp, x, enabled=save_spmm)


def _stack_outs(outs, model_type):
    """[T, N, out], or (embs, trans) stacked for the 'S' variant."""
    if model_type == "S":
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return torch.stack(outs)


def _mlp(model_type, input_dim, hidden_dim, output_dim, trans_num, bias,
         trans_activate_type, generator):
    """A snapshot's MLP: 'C' in -> hid, 'S' in -> hid -> out."""
    if model_type not in ("C", "S"):
        raise ValueError(f"model_type {model_type!r}")
    return MLP(input_dim, hidden_dim,
               hidden_dim if model_type == "C" else output_dim, trans_num,
               bias=bias, activate_type=trans_activate_type,
               generator=generator)


def _cdn(model_type, hidden_dim, output_dim, diffusion_num, **kw):
    """A snapshot's CDN: 'C' hid -> out, 'S' out -> out."""
    return CDN(hidden_dim if model_type == "C" else output_dim, output_dim,
               output_dim, diffusion_num, **kw)


class _Family(nn.Module):
    """What CGCN and CTGCN share: the window-level knobs and the window
    loop over per-snapshot steps."""

    def _knobs(self, act_budget, remat_policy, batch_window_tail):
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}, not one of "
                             f"{REMAT_POLICIES}")
        self.act_budget = act_budget
        self.remat_policy = remat_policy
        self.batch_window_tail = batch_window_tail

    def _window(self, xs, pyramids, mlp_at, cdn_at, cdns):
        """[T, N, out] (and the MLP outputs for 'S') of the snapshots'
        ``mlp_at(t)`` and ``cdn_at(t)``; ``cdns`` the window tail's CDN(s)
        when it runs."""
        if self.batch_window_tail and pyramids.backend == "blocks":
            trans = torch.stack([
                mlp_at(t)(None if xs is None else xs[t])
                for t in range(pyramids.valid.shape[0])])
            embs = _window_tail(cdns, trans, pyramids, self.act_budget)
            return (embs, trans) if self.model_type == "S" else embs

        def step(t, x, pyramid, save_spmm):
            trans = _run_mlp(mlp_at(t), x, save_spmm)
            emb = cdn_at(t)(trans, pyramid, save_spmm)
            return (emb, trans) if self.model_type == "S" else emb

        return _stack_outs(_over_window(step, xs, pyramids, cdn_at(0),
                                        self.act_budget, self.remat_policy),
                           self.model_type)


class CGCN(_Family):
    """Static k-core GCN: one MLP + CDN shared by every snapshot of the
    window ('C': MLP(in -> hid), CDN(hid -> out); 'S': MLP(in -> hid ->
    out), CDN(out -> out)).  Returns [T, N, out], or (embs, trans) for
    'S', trans being the MLP output (the structure embedding)."""

    def __init__(self, input_dim, hidden_dim, output_dim, trans_num,
                 diffusion_num, bias=True, rnn_type="GRU", model_type="C",
                 trans_activate_type="L", generator=None,
                 act_budget=ACT_BUDGET, remat_policy="full",
                 batch_window_tail=False, layer_remat=False, **layer_kw):
        super().__init__()
        self.mlp = _mlp(model_type, input_dim, hidden_dim, output_dim,
                        trans_num, bias, trans_activate_type, generator)
        self.cdn = _cdn(model_type, hidden_dim, output_dim, diffusion_num,
                        bias=bias, rnn_type=rnn_type, generator=generator,
                        layer_remat=layer_remat, **layer_kw)
        self.model_type = model_type
        self._knobs(act_budget, remat_policy, batch_window_tail)

    def forward(self, xs, pyramids: CorePyramid):
        return self._window(xs, pyramids, lambda t: self.mlp,
                            lambda t: self.cdn, self.cdn)


class CTGCN(_Family):
    """Temporal k-core GCN: per timestep an MLP and a CDN with their own
    parameters (the shapes of ``CGCN``'s variant), then one time-axis RNN
    and LayerNorm.  Returns [T, N, out], or (out, trans) for 'S'."""

    time_rule = TimeRule(("mlps", "cdns"), ("rnn", "norm"))

    def __init__(self, input_dim, hidden_dim, output_dim, trans_num,
                 diffusion_num, duration, bias=True, rnn_type="GRU",
                 model_type="C", trans_activate_type="L", generator=None,
                 act_budget=ACT_BUDGET, remat_policy="full",
                 batch_window_tail=False, layer_remat=False, **layer_kw):
        super().__init__()
        self.mlps = nn.ModuleList(
            _mlp(model_type, input_dim, hidden_dim, output_dim, trans_num,
                 bias, trans_activate_type, generator)
            for _ in range(duration))
        self.cdns = nn.ModuleList(
            _cdn(model_type, hidden_dim, output_dim, diffusion_num,
                 bias=bias, rnn_type=rnn_type, generator=generator,
                 layer_remat=layer_remat, **layer_kw)
            for _ in range(duration))
        self.rnn = _make_rnn(rnn_type, output_dim, output_dim, bias,
                             generator)
        self.norm = LayerNorm(output_dim)
        self.duration = duration
        self.model_type = model_type
        self._knobs(act_budget, remat_policy, batch_window_tail)

    def per_timestep(self, xs, pyramids: CorePyramid):
        """Per-timestep MLP + CDN stacks over the window: [T, N, out]
        (and the MLP outputs [T, N, out] for 'S')."""
        return self._window(xs, pyramids, lambda t: self.mlps[t],
                            lambda t: self.cdns[t], self.cdns)

    def forward(self, xs, pyramids: CorePyramid):
        res = self.per_timestep(xs, pyramids)
        hx = res[0] if self.model_type == "S" else res
        outs, _ = rnn_scan(self.rnn, hx)
        out = self.norm(outs)
        return (out, res[1]) if self.model_type == "S" else out
