# coding: utf-8
"""CorePyramid: a snapshot's k-core adjacency hierarchy as BSR plans.

Per snapshot the k-core matrices come max core first; I is added to the
first (max-core) matrix only, and a core whose delta against the previous
kept core is empty is dropped.  Here the pyramid is a fixed bank of K core
slots whose dropped or absent slots are marked invalid by ``valid``: a
masked slot neither extends the diffusion prefix sum nor advances the
core-axis RNN, which equals dropping it.  All K slot products run as one
block-diagonal BSR product (``ops.bsr_spmm.build_pyramid_plans``).

Only the BSR-plan backend is ported; the dense, core-sorted blocks and ELL
backends of ``ctgcn_tpu/ops/pyramid.py`` are listed in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.ops.bsr_spmm import BlockPlan, build_pyramid_plans


@dataclasses.dataclass(frozen=True)
class CorePyramid:
    """One snapshot (``valid`` bool[K], one plan each way) or a stacked
    window (``valid`` bool[T, K], tuples of T plans)."""

    valid: torch.Tensor
    n_nodes: int
    plan_fwd: BlockPlan | tuple
    plan_t: BlockPlan | tuple

    @property
    def num_slots(self) -> int:
        return int(self.valid.shape[-1])

    def to(self, device) -> "CorePyramid":
        def move(p):
            return (tuple(q.to(device) for q in p) if isinstance(p, tuple)
                    else p.to(device))

        return dataclasses.replace(self, valid=self.valid.to(device),
                                   plan_fwd=move(self.plan_fwd),
                                   plan_t=move(self.plan_t))


def build_core_pyramid(core_mats, n_nodes, num_slots):
    """Host CorePyramid from scipy matrices ordered max core first (the
    caller truncates to ``max_core`` and reverses): I is added to slot 0,
    and a core equal to the previous one is dropped.

    Args:
      num_slots: fixed K (>= number of kept cores).
    """
    kept = []
    prev = None
    for j, mat in enumerate(core_mats):
        mat = mat.tocsr()
        if j == 0:
            kept.append(mat + sp.eye(n_nodes, format="csr"))
        elif abs(mat - prev).sum() != 0:
            kept.append(mat)
        prev = mat

    K = int(num_slots)
    if len(kept) > K:
        raise ValueError(f"{len(kept)} kept cores > {K} slots")
    valid = np.zeros((K,), bool)
    valid[:len(kept)] = True
    plan_fwd, plan_t = build_pyramid_plans(list(enumerate(kept)), n_nodes, K)
    return CorePyramid(valid=torch.from_numpy(valid), n_nodes=int(n_nodes),
                       plan_fwd=plan_fwd, plan_t=plan_t)


def stack_pyramids(pyramids):
    """Stack host per-snapshot pyramids (same K) into a window: ``valid``
    [T, K], and a tuple of each snapshot's own plans per direction.  The
    JAX package pads the plans to one block count to stack them into one
    array; a tuple needs no shared shape, so no padding blocks are made
    or multiplied."""
    return CorePyramid(
        valid=torch.stack([p.valid for p in pyramids]),
        n_nodes=pyramids[0].n_nodes,
        plan_fwd=tuple(p.plan_fwd for p in pyramids),
        plan_t=tuple(p.plan_t for p in pyramids))


def pyramid_at(stacked: CorePyramid, t: int) -> CorePyramid:
    """Snapshot ``t`` of a stacked window."""
    return CorePyramid(valid=stacked.valid[t], n_nodes=stacked.n_nodes,
                       plan_fwd=stacked.plan_fwd[t],
                       plan_t=stacked.plan_t[t])
