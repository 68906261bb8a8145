# coding: utf-8
"""Row-partitioned SpMM over the parts of a run (port of
``ctgcn_tpu/parallel/graph_partition.py``).

A snapshot's adjacency is split by destination rows: part p owns output
rows [p·rpp, (p+1)·rpp) and the same rows of x, rpp = ⌈⌈N/P⌉/8⌉·8.  The
host plans (``partition_graph``, ``partition_graph_halo``) are the JAX
package's, array for array: padded [P, cap] COO slabs (``pad_bucket``
caps, lexsorted by part, local row and column), and for the halo the send
table ``halo_send[q, p, :]`` (the q-local x rows that part q ships to part
p; padding repeats row 0) with remote columns remapped to the receive
buffer's slot q·H + j, j the column's place in the sorted (q -> p) list.

Each rank keeps only its own part on its device: ``part(p)`` turns the
slab into ``CsrPlan`` pairs (forward and transpose, the zero-valued
padding dropped), whose products go through ``ell_spmm`` / ``csr_spmm``, so
that on the card ``dispatch`` runs them on ``bsr_spmm_rowwalk`` or
``bsr_spmm_blockpar`` (the JAX package's ``segment_sum`` on a TPU).

  * ``sharded_spmm``: all-gather x, then the local product (the 1D pattern;
    every part receives all of x).
  * ``sharded_spmm_halo``: ship only the boundary rows (P·H·d values a part
    instead of N·d).  The ``all_to_all_single`` starts without waiting, the
    LOCAL product runs while it is in flight, then the REMOTE product reads
    the receive buffer.
  * ``halo_gcn_forward``: the zoo's GCN with every SpMM on the halo path.
    A part computes its own rows only; the rows of every part are
    all-gathered at the end (``dist.gather_own``), where every part
    computes the same loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from torch.nn import functional as F

from ctgcn_torch.ops.bsr_spmm import CsrPlan, build_csr_plan
from ctgcn_torch.ops.ell import ell_spmm
from ctgcn_torch.parallel.dist import (Parts, gather_own, gather_summed,
                                       start_exchange)
from ctgcn_torch.utils import pad_bucket


def rows_per_part(n, n_parts):
    """⌈⌈n / P⌉ / 8⌉ · 8 (a multiple of the TPU's 8 sublanes, kept so the
    plans are the JAX package's)."""
    return -(-(-(-n // n_parts)) // 8) * 8


def own_rows(n_nodes, rpp, index):
    """(first row, row count) of part ``index``'s real nodes: the last
    parts may hold fewer than rpp, or none."""
    lo = index * rpp
    return lo, max(0, min(rpp, n_nodes - lo))


def _plan_pair(rows, cols, vals, n_rows, n_cols, row_group=None):
    """(forward, transpose) ``CsrPlan``s of a padded COO slab, its
    zero-valued padding dropped."""
    keep = vals != 0
    mat = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                        shape=(n_rows, n_cols))
    return build_csr_plan(mat, row_group=row_group), build_csr_plan(mat.T)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Row-partitioned padded COO of every part (host, the JAX layout).

    rows: int32[P, cap] slab-local row ids (0 for padding).
    cols: int32[P, cap] global column ids.
    vals: f32[P, cap], 0 for padding.
    rows_per_part / n_cols: the sizes (n_rows = P · rows_per_part).
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    rows_per_part: int
    n_cols: int

    @property
    def parts(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_rows(self) -> int:
        return self.parts * self.rows_per_part

    def part(self, p) -> "GatherPart":
        """Part p's plans (host): [rpp, P·rpp] and its transpose; x rows
        past ``n_cols`` are the gathered x's padding."""
        if self.n_cols > self.n_rows:
            raise ValueError(f"{self.n_cols} columns do not fit the "
                             f"{self.n_rows} gathered rows of x")
        fwd, t = _plan_pair(self.rows[p], self.cols[p], self.vals[p],
                            self.rows_per_part, self.n_rows)
        return GatherPart(fwd=fwd, t=t, index=p)


def partition_graph(mat, n_parts, cap=None) -> PartitionedGraph:
    """scipy sparse [N, M] -> row-partitioned slabs (host side)."""
    coo = mat.tocoo()
    n, m = mat.shape
    rpp = rows_per_part(n, n_parts)
    keep = coo.data != 0
    r, c, v = coo.row[keep], coo.col[keep], coo.data[keep]
    part = r // rpp
    local_r = r % rpp
    counts = np.bincount(part, minlength=n_parts)
    cap = int(cap) if cap is not None else pad_bucket(max(int(counts.max()),
                                                          1))
    rows = np.zeros((n_parts, cap), np.int32)
    cols = np.zeros((n_parts, cap), np.int32)
    vals = np.zeros((n_parts, cap), np.float32)
    order = np.lexsort((c, local_r, part))
    local_r, c, v = local_r[order], c[order], v[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for p in range(n_parts):
        s, e = starts[p], starts[p] + counts[p]
        rows[p, :counts[p]] = local_r[s:e]
        cols[p, :counts[p]] = c[s:e]
        vals[p, :counts[p]] = v[s:e]
    return PartitionedGraph(rows=rows, cols=cols, vals=vals,
                            rows_per_part=int(rpp), n_cols=int(m))


@dataclasses.dataclass(frozen=True)
class GatherPart:
    """One part of a ``PartitionedGraph``: its rows' plan pair."""

    fwd: CsrPlan
    t: CsrPlan
    index: int

    def to(self, device) -> "GatherPart":
        return dataclasses.replace(self, fwd=self.fwd.to(device),
                                   t=self.t.to(device))


def sharded_spmm(part: GatherPart, x_shard, parts: Parts):
    """This part's rows of ``A @ x``: x_shard [rpp, d] (this part's rows of
    x) is all-gathered to [P·rpp, d], then multiplied by the part's slab.
    Backward: each part's dx is the sum of every part's A_p^T g_p over its
    rows."""
    return ell_spmm(part.fwd, part.t, gather_summed(x_shard, parts))


def sharded_gcn_layer(part: GatherPart, x_shard, weight, bias, parts: Parts):
    """One row-sharded graph convolution: this part's rows of
    ``A @ (x W) + b`` (W, b replicated)."""
    out = sharded_spmm(part, x_shard @ weight, parts)
    return out if bias is None else out + bias


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloPartitionedGraph:
    """Destination-row partitioned COO of every part with the halo plan
    (host, the JAX layout).

    local_rows / local_cols / local_vals: int32 / int32 / f32 [P, capL]
      slab-local COO of the edges whose column the part owns.
    remote_rows / remote_idx / remote_vals: [P, capR]; remote_idx indexes
      the [P·H, d] receive buffer.
    halo_send: int32[P, P, H], entry [q, p, j] the q-local x row that part
      q ships to part p in slot j.
    """

    local_rows: np.ndarray
    local_cols: np.ndarray
    local_vals: np.ndarray
    remote_rows: np.ndarray
    remote_idx: np.ndarray
    remote_vals: np.ndarray
    halo_send: np.ndarray
    rows_per_part: int
    n_cols: int
    halo_width: int

    @property
    def parts(self) -> int:
        return int(self.local_rows.shape[0])

    @property
    def n_rows(self) -> int:
        return self.parts * self.rows_per_part

    @property
    def comm_rows_per_chip(self) -> int:
        """x rows each part ships per SpMM (N for the all-gather)."""
        return self.parts * self.halo_width

    def part(self, p) -> "HaloPart":
        """Part p's plans (host)."""
        return halo_part(self, p, self.rows_per_part, self.n_cols, None)


@dataclasses.dataclass(frozen=True)
class HaloPart:
    """One part of a halo plan, what its rank holds: the LOCAL plan pair
    [R, rpp] and transpose, the REMOTE pair [R, P·H] and transpose, and the
    send table (int64 [P, H]); R is rpp, or K·rpp for a pyramid's
    flattened slots (row k·rpp + r), whose ``valid`` it carries, and
    ``kept``, the count of its valid slots on the host."""

    local_fwd: CsrPlan
    local_t: CsrPlan
    remote_fwd: CsrPlan
    remote_t: CsrPlan
    send: torch.Tensor
    index: int
    count: int
    rows_per_part: int
    halo_width: int
    n_nodes: int
    valid: torch.Tensor | None = None
    kept: int = 0

    @property
    def num_slots(self) -> int:
        return 1 if self.valid is None else int(self.valid.shape[0])

    @property
    def own(self):
        """(first row, row count) of the part's real nodes."""
        return own_rows(self.n_nodes, self.rows_per_part, self.index)

    def to(self, device) -> "HaloPart":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, CsrPlan))})


def halo_part(plan, p, rpp, n_nodes, valid):
    """``HaloPart`` p of a halo plan (``HaloPartitionedGraph`` or the
    pyramid's ``PartitionedPyramid``): its slabs' plan pairs, its row of
    ``halo_send``."""
    n_flat = rpp if valid is None else len(valid) * rpp
    # a node's slot rows side by side in the row walk (nested cores share
    # columns)
    group = np.arange(n_flat) % rpp
    local_fwd, local_t = _plan_pair(plan.local_rows[p], plan.local_cols[p],
                                    plan.local_vals[p], n_flat, rpp, group)
    remote_fwd, remote_t = _plan_pair(
        plan.remote_rows[p], plan.remote_idx[p], plan.remote_vals[p], n_flat,
        plan.parts * plan.halo_width, group)
    return HaloPart(
        local_fwd=local_fwd, local_t=local_t, remote_fwd=remote_fwd,
        remote_t=remote_t,
        send=torch.from_numpy(plan.halo_send[p].astype(np.int64)), index=p,
        count=plan.parts, rows_per_part=rpp, halo_width=plan.halo_width,
        n_nodes=n_nodes,
        valid=None if valid is None else torch.from_numpy(valid.copy()),
        kept=0 if valid is None else int(valid.sum()))


def halo_lists(rows, cols, n_parts, rpp):
    """The (q -> p) halo lists of the nonzeros (rows, cols): for each part
    p the sorted unique columns of part q that p's rows read; H the longest
    list (1 when there is none); ``halo_send`` [P, P, H]."""
    part = rows // rpp
    col_part = cols // rpp
    halo_cols = {}
    for p in range(n_parts):
        sel = (part == p) & (col_part != p)
        if not sel.any():
            continue
        for q in np.unique(col_part[sel]):
            qsel = sel & (col_part == q)
            halo_cols[(int(q), p)] = np.unique(cols[qsel])
    H = max((len(x) for x in halo_cols.values()), default=1)
    halo_send = np.zeros((n_parts, n_parts, H), np.int32)
    for (q, p), cols_qp in halo_cols.items():
        halo_send[q, p, :len(cols_qp)] = cols_qp - q * rpp
    return halo_cols, H, halo_send


def partition_graph_halo(mat, n_parts) -> HaloPartitionedGraph:
    """scipy sparse [N, N] -> destination-row slabs + halo plan (host)."""
    coo = mat.tocoo()
    n, m = mat.shape
    if n != m:
        raise ValueError("halo partitioning needs a square adjacency")
    rpp = rows_per_part(n, n_parts)
    keep = coo.data != 0
    r = coo.row[keep].astype(np.int64)
    c = coo.col[keep].astype(np.int64)
    v = coo.data[keep].astype(np.float32)
    part = r // rpp
    col_part = c // rpp
    is_local = part == col_part
    halo_cols, H, halo_send = halo_lists(r, c, n_parts, rpp)

    def pack(sel_mask, remap):
        counts = np.bincount(part[sel_mask], minlength=n_parts)
        cap = pad_bucket(max(int(counts.max()), 1))
        rows_a = np.zeros((n_parts, cap), np.int32)
        cols_a = np.zeros((n_parts, cap), np.int32)
        vals_a = np.zeros((n_parts, cap), np.float32)
        pp = part[sel_mask]
        rr = (r[sel_mask] % rpp).astype(np.int64)
        cc = remap
        vv = v[sel_mask]
        order = np.lexsort((cc, rr, pp))
        rr, cc, vv = rr[order], cc[order], vv[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for p in range(n_parts):
            s, e = starts[p], starts[p] + counts[p]
            rows_a[p, :counts[p]] = rr[s:e]
            cols_a[p, :counts[p]] = cc[s:e]
            vals_a[p, :counts[p]] = vv[s:e]
        return rows_a, cols_a, vals_a

    l_rows, l_cols, l_vals = pack(is_local, c[is_local] % rpp)
    # remote columns -> receive-buffer slots q·H + j
    rsel = ~is_local
    remote_slot = np.zeros(int(rsel.sum()), np.int64)
    ridx = np.flatnonzero(rsel)
    for (q, p), cols_qp in halo_cols.items():
        esel = (part[ridx] == p) & (col_part[ridx] == q)
        remote_slot[esel] = q * H + np.searchsorted(cols_qp, c[ridx[esel]])
    r_rows, r_idx, r_vals = pack(rsel, remote_slot)
    return HaloPartitionedGraph(
        local_rows=l_rows, local_cols=l_cols, local_vals=l_vals,
        remote_rows=r_rows, remote_idx=r_idx, remote_vals=r_vals,
        halo_send=halo_send, rows_per_part=int(rpp), n_cols=int(m),
        halo_width=int(H))


def sharded_spmm_halo(part: HaloPart, x_shard, parts: Parts):
    """This part's rows of ``A @ x`` with boundary-only exchange, from its
    x rows x_shard [rpp, d]: [R, d], R = rpp, or K·rpp for a pyramid's
    flattened slots.  The exchange starts, the LOCAL product runs while it
    is in flight, then the REMOTE product reads what arrived."""
    x = x_shard.float()
    recv, wait = start_exchange(x, part.send, parts)
    out = ell_spmm(part.local_fwd, part.local_t, x)
    wait()
    return out + ell_spmm(part.remote_fwd, part.remote_t, recv)


def halo_spmm_layer(part: HaloPart, support, parts: Parts):
    """This part's real rows of ``A @ support``: support [n_own, d] (the
    part's real nodes) is padded to rpp rows and the result cropped back."""
    n_own = part.own[1]
    x = F.pad(support, (0, 0, 0, part.rows_per_part - n_own))
    return sharded_spmm_halo(part, x, parts)[:n_own]


def gather_rows(slabs, parts: Parts, n_nodes):
    """[T, rpp, d] slabs of every part -> [T, N, d] on every part (the
    parts' rows in order, padding cropped); backward: the part's own
    rows' gradient (every part computes the same loss from the result)."""
    full = gather_own(slabs.transpose(0, 1).contiguous(), parts)
    return full.transpose(0, 1)[:, :n_nodes]


def dropout_rows(h, rate, generator, n_nodes, lo):
    """The zoo's inverted dropout on rows lo.. of an [N, d] tensor: the
    mask of the whole [N, d] is drawn from ``generator`` and sliced, so
    every part draws what the single-device forward draws."""
    if generator is None or not rate:
        return h
    keep = torch.rand((n_nodes, h.shape[1]), generator=generator,
                      device=h.device)[lo:lo + h.shape[0]] < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


def halo_gcn_forward(gcn, xs, hparts, n_nodes, parts: Parts,
                     generator=None):
    """The zoo's GCN window forward with every SpMM halo-partitioned:
    ``gcn`` (``nn.gcn.GCN``, weights replicated); xs [T, N, in] or None
    (identity features: a part's rows of I W are W's rows); ``hparts`` this
    rank's ``HaloPart`` of each snapshot.  Returns [T, N, out] on every
    part; dropout draws from ``generator`` as ``GCN.forward`` does."""
    outs = []
    for t, part in enumerate(hparts):
        lo, n_own = part.own

        def conv(layer, h):
            support = (layer.weight[lo:lo + n_own] if h is None
                       else h @ layer.weight)
            out = halo_spmm_layer(part, support, parts)
            return out if layer.bias is None else out + layer.bias

        x = None if xs is None else xs[t][lo:lo + n_own]
        h = F.relu(conv(gcn.gc1, x))
        h = dropout_rows(h, gcn.dropout, generator, n_nodes, lo)
        out = conv(gcn.gc2, h)
        outs.append(F.pad(out, (0, 0, 0, part.rows_per_part - n_own)))
    return gather_rows(torch.stack(outs), parts, n_nodes)
