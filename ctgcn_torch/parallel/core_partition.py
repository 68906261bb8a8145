# coding: utf-8
"""Row-partitioned k-core pyramid diffusion over the parts of a run (port
of ``ctgcn_tpu/parallel/core_partition.py``): one snapshot's CGCN / CTGCN
layers split across GPUs by node rows.

Every stage after the slot products (the prefix over the core slots, the
"+x" for slot 0's +I, ReLU, the core-axis RNN and its sum, LayerNorm) works
row by row, so a part runs the whole layer on its own rows.  The slots are
delta-encoded (Δ_k = A_k - A_{k-1}, exact for nested cores), so the union
of every slot's edges is the last kept core's: ONE halo plan built from it
serves all K slots, and one exchange a layer ships each boundary row once.

Host plans (``partition_pyramid_halo``) are the JAX package's, array for
array: a slot whose delta from the previous kept core is empty is dropped
(``valid`` False), slot 0's +I is not stored, edges are flattened over the
slots as row k·rpp + r (padding: value 0 on the last flattened row).  A
rank keeps its part as a ``HaloPart`` whose products run on the CSR
kernels (``graph_partition.sharded_spmm_halo``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from torch.nn import functional as F

from ctgcn_torch.nn.core_models import CTGCN
from ctgcn_torch.ops.rnn import core_rnn_sum, rnn_scan
from ctgcn_torch.parallel.dist import Parts
from ctgcn_torch.parallel.graph_partition import (
    HaloPart, gather_rows, halo_lists, halo_part, rows_per_part,
    sharded_spmm_halo)
from ctgcn_torch.utils import pad_bucket


@dataclasses.dataclass(frozen=True)
class PartitionedPyramid:
    """Delta-encoded core slots of every part, destination-row partitioned,
    with one shared halo plan (host, the JAX layout).

    local_rows / local_cols / local_vals: [P, capL], rows flattened k·rpp+r.
    remote_rows / remote_idx / remote_vals: [P, capR].
    halo_send: int32[P, P, H].
    valid: bool[K], the delta-skip mask.
    """

    local_rows: np.ndarray
    local_cols: np.ndarray
    local_vals: np.ndarray
    remote_rows: np.ndarray
    remote_idx: np.ndarray
    remote_vals: np.ndarray
    halo_send: np.ndarray
    valid: np.ndarray
    rows_per_part: int
    n_nodes: int
    halo_width: int
    num_slots: int

    @property
    def parts(self) -> int:
        return int(self.local_rows.shape[0])

    @property
    def n_rows(self) -> int:
        return self.parts * self.rows_per_part

    def part(self, p) -> HaloPart:
        """Part p's plans (host): [K·rpp, rpp] local, [K·rpp, P·H]
        remote, their transposes, the send table and ``valid``."""
        return halo_part(self, p, self.rows_per_part, self.n_nodes,
                         self.valid)


def partition_pyramid_halo(core_mats, n_nodes, n_parts,
                           num_slots=None) -> PartitionedPyramid:
    """scipy core matrices of one snapshot (max core first, as
    ``DataLoader.get_core_scipy_list`` reads them) -> delta slots
    partitioned over ``n_parts`` (host)."""
    kept = []
    prev = None
    for j, mat in enumerate(core_mats):
        mat = mat.tocsr()
        if j > 0 and prev is not None and abs(mat - prev).sum() == 0:
            prev = mat
            continue
        kept.append(mat)
        prev = mat
    K = int(num_slots) if num_slots is not None else max(len(kept), 1)
    if len(kept) > K:
        raise ValueError(f"{len(kept)} kept cores do not fit {K} slots")
    valid = np.zeros(K, bool)
    valid[:len(kept)] = True
    deltas = [kept[0]] + [(kept[k] - kept[k - 1]).tocoo()
                          for k in range(1, len(kept))]
    union = kept[-1] if kept else sp.coo_matrix((n_nodes, n_nodes))
    rpp = rows_per_part(n_nodes, n_parts)

    # the shared halo plan, from the union's nonzeros
    uc = union.tocoo()
    unz = uc.data != 0
    halo_cols, H, halo_send = halo_lists(uc.row[unz].astype(np.int64),
                                         uc.col[unz].astype(np.int64),
                                         n_parts, rpp)

    # the delta slots' edges, flattened, per part
    loc = {p: ([], [], []) for p in range(n_parts)}
    rem = {p: ([], [], []) for p in range(n_parts)}
    for k, d in enumerate(deltas):
        coo = d.tocoo()
        nz = coo.data != 0
        r = coo.row[nz].astype(np.int64)
        c = coo.col[nz].astype(np.int64)
        v = coo.data[nz].astype(np.float32)
        part = r // rpp
        cpart = c // rpp
        flat_r = k * rpp + (r % rpp)
        is_local = part == cpart
        for p in range(n_parts):
            psel = part == p
            lsel = psel & is_local
            loc[p][0].append(flat_r[lsel])
            loc[p][1].append(c[lsel] % rpp)
            loc[p][2].append(v[lsel])
            rsel = psel & ~is_local
            if rsel.any():
                slot = np.empty(int(rsel.sum()), np.int64)
                ridx = np.flatnonzero(rsel)
                for q in np.unique(cpart[ridx]):
                    esel = cpart[ridx] == q
                    slot[esel] = q * H + np.searchsorted(
                        halo_cols[(int(q), p)], c[ridx[esel]])
                rem[p][0].append(flat_r[rsel])
                rem[p][1].append(slot)
                rem[p][2].append(v[rsel])

    def pack(per_part, n_rows_flat):
        cat = {p: tuple(np.concatenate(a) if a else np.zeros(0)
                        for a in abc) for p, abc in per_part.items()}
        cap = pad_bucket(max((len(c[0]) for c in cat.values()), default=1))
        rows_a = np.full((n_parts, cap), n_rows_flat - 1, np.int32)
        cols_a = np.zeros((n_parts, cap), np.int32)
        vals_a = np.zeros((n_parts, cap), np.float32)
        for p, (rr, cc, vv) in cat.items():
            # sorted by flattened row; padding (value 0) on the last row
            order = np.argsort(rr, kind="stable")
            n = len(rr)
            rows_a[p, :n] = rr[order]
            cols_a[p, :n] = cc[order]
            vals_a[p, :n] = vv[order]
        return rows_a, cols_a, vals_a

    l_rows, l_cols, l_vals = pack(loc, K * rpp)
    r_rows, r_idx, r_vals = pack(rem, K * rpp)
    return PartitionedPyramid(
        local_rows=l_rows, local_cols=l_cols, local_vals=l_vals,
        remote_rows=r_rows, remote_idx=r_idx, remote_vals=r_vals,
        halo_send=halo_send, valid=valid, rows_per_part=int(rpp),
        n_nodes=int(n_nodes), halo_width=int(H), num_slots=K)


def partitioned_core_diffusion(layer, x_shard, part: HaloPart, parts: Parts):
    """One CoreDiffusion layer on this part's rows: x_shard [rpp, d] ->
    [rpp, out].

    The delta slots' products (one exchange, the local and remote products
    over the flattened [K·rpp] rows), masked by ``valid``; the prefix
    A_k x = Σ_{i<=k} Δ_i x as the exact (L·L) product over the slots (L the
    lower-triangular ones) and "+x" for slot 0's +I; then ReLU·valid, the
    masked core-axis RNN summed (``core_rnn_sum``, as the single-device
    layer runs it) and LayerNorm."""
    K, rpp = part.num_slots, part.rows_per_part
    x = x_shard.float()
    valid = part.valid.float()
    contribs = sharded_spmm_halo(part, x, parts).reshape(K, rpp, -1) \
        * valid[:, None, None]
    lower = torch.tril(torch.ones(K, K, device=x.device))
    acc = ((lower @ lower) @ contribs.reshape(K, -1)).reshape(contribs.shape)
    acc = acc + x[None]
    return layer.norm(core_rnn_sum(layer.rnn, acc, valid,
                                   layer.cvjp_batch_budget, kept=part.kept))


def halo_core_forward(model, xs, hparts, n_nodes, parts: Parts):
    """CGCN / CTGCN window forward with every CoreDiffusion layer
    partitioned by rows: ``model`` (``nn.core_models.CGCN``, shared
    parameters, or ``CTGCN``, a module a timestep, all replicated); xs
    [T, N, in] or None (identity features); ``hparts`` this rank's
    ``HaloPart`` of each snapshot.  Each part runs the layers on its own
    rows of the MLP's output (so the MLP's gradient is the part's share,
    as the layers' is); the rows are all-gathered, then CTGCN's time RNN
    and LayerNorm run on the assembled [T, N, out] on every part.  Returns
    the model's convention: [T, N, out], or (embs, trans) for 'S'."""
    is_ctgcn = isinstance(model, CTGCN)
    embs, transs = [], []
    for t, part in enumerate(hparts):
        mlp, cdn = ((model.mlps[t], model.cdns[t]) if is_ctgcn
                    else (model.mlp, model.cdn))
        lo, n_own = part.own
        trans = F.pad(mlp(None if xs is None else xs[t])[lo:lo + n_own],
                      (0, 0, 0, part.rows_per_part - n_own))
        h = trans
        for layer in cdn.layers:
            h = partitioned_core_diffusion(layer, h, part, parts)
        embs.append(h)
        transs.append(trans)
    hx = gather_rows(torch.stack(embs), parts, n_nodes)
    if is_ctgcn:
        outs, _ = rnn_scan(model.rnn, hx)
        hx = model.norm(outs)
    if model.model_type == "S":
        return hx, gather_rows(torch.stack(transs), parts, n_nodes)
    return hx
