# coding: utf-8
"""Node centralities of a snapshot, in torch float64 on a device: what
``networkx`` computes over ``nx.from_scipy_sparse_array(adj)`` with its
defaults (unweighted, every node of the node list counted in n).

* closeness (``wf_improved``): ``(r-1)/sum(d) * (r-1)/(n-1)`` from
  breadth-first distances, 0 where a node reaches nothing;
* betweenness: Brandes' algorithm, level-synchronous over a batch of
  sources at once (path counts forward level by level, dependencies
  backward), normalized by ``1/((n-1)(n-2))``;
* eigenvector: networkx's power iteration itself (start at 1/n,
  ``x <- (A + I) x`` then L2-normalized, until the L1 change is below
  ``n * tol``), since on a disconnected graph the answer depends on the
  start and the step count;
* k-core: :func:`ctgcn_torch.preprocessing.kcore.core_numbers`.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ctgcn_torch.preprocessing.kcore import core_numbers

#: device bytes the breadth-first state of one batch of sources may take
#: (about 8 float64 or int64 [n, sources] arrays)
BFS_STATE_BYTES = 1 << 30


def edge_pattern(adj, device):
    """The graph's unweighted symmetric adjacency (every stored entry an
    edge, self-loops kept) as a float64 sparse CSR tensor on ``device``."""
    a = sp.csr_matrix(adj)
    a = sp.csr_matrix((np.ones(a.nnz), a.indices, a.indptr), shape=a.shape)
    a = (a + a.T).tocsr()
    a.sort_indices()
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.ones(a.nnz, dtype=torch.float64), a.shape,
        check_invariants=False).to(device)


def shortest_path_centralities(A, state_bytes=BFS_STATE_BYTES):
    """(closeness, betweenness), float64 [n] tensors, of the pattern ``A``
    from :func:`edge_pattern`."""
    n, dev = A.shape[0], A.device
    closeness = torch.zeros(n, dtype=torch.float64, device=dev)
    betweenness = torch.zeros(n, dtype=torch.float64, device=dev)
    batch = max(1, min(n, state_bytes // (64 * n)))
    for s0 in range(0, n, batch):
        src = torch.arange(s0, min(n, s0 + batch), device=dev)
        cols = torch.arange(len(src), device=dev)
        dist = torch.full((n, len(src)), -1, dtype=torch.int64, device=dev)
        dist[src, cols] = 0
        sigma = torch.zeros(n, len(src), dtype=torch.float64, device=dev)
        sigma[src, cols] = 1.0
        front = dist == 0
        levels = [front]
        while True:
            paths = A @ (sigma * front)
            new = (paths > 0) & (dist < 0)
            if not bool(new.any()):
                break
            sigma = torch.where(new, paths, sigma)
            dist = torch.where(new, len(levels), dist)
            front = new
            levels.append(new)
        reach = ((dist >= 0).sum(0) - 1).to(torch.float64)
        total = dist.clamp(min=0).sum(0).to(torch.float64)
        if n > 1:
            closeness[src] = torch.where(
                total > 0, reach / total * (reach / (n - 1)), 0.0)
        delta = torch.zeros_like(sigma)
        for d in range(len(levels) - 1, 0, -1):
            coeff = torch.where(levels[d], (1 + delta) / sigma, 0.0)
            delta = delta + torch.where(levels[d - 1], sigma * (A @ coeff),
                                        0.0)
        betweenness += torch.where(dist > 0, delta, 0.0).sum(1)
    if n > 2:
        betweenness *= 1 / ((n - 1) * (n - 2))
    return closeness, betweenness


def eigenvector_centrality(A, max_iter=1000, tol=1e-6):
    """networkx's eigenvector centrality of the pattern ``A``, float64
    [n]; raises ``RuntimeError`` if it does not converge."""
    n = A.shape[0]
    if n == 0:
        raise ValueError("cannot compute centrality for the null graph")
    x = torch.full((n,), 1.0 / n, dtype=torch.float64, device=A.device)
    for _ in range(max_iter):
        x_last = x
        x = x_last + A @ x_last
        norm = float(torch.linalg.vector_norm(x)) or 1.0
        x = x / norm
        if float((x - x_last).abs().sum()) < n * tol:
            return x
    raise RuntimeError(f"power iteration failed to converge within "
                       f"{max_iter} iterations")


def node_centralities(adj, device):
    """closeness, betweenness, eigenvector (float64) and kcore (int64)
    numpy arrays over every node of the adjacency ``adj``."""
    A = edge_pattern(adj, device)
    closeness, betweenness = shortest_path_centralities(A)
    eigenvector = eigenvector_centrality(A)
    return {"closeness": closeness.cpu().numpy(),
            "betweenness": betweenness.cpu().numpy(),
            "eigenvector": eigenvector.cpu().numpy(),
            "kcore": core_numbers(adj)}
