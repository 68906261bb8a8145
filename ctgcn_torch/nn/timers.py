# coding: utf-8
"""TIMERS: error-bounded incremental SVD on dynamic networks (port of
``ctgcn_tpu/nn/timers.py``).

A truncated SVD of the first snapshot, then a TRIP eigen-update per
snapshot's change, its loss ``||S - U V^T||_F^2`` held against a
matrix-perturbation lower bound, and a full SVD again whenever ``loss >=
(1 + theta) * bound``.  Each snapshot's embedding is ``[U sqrt(S) ‖ V
sqrt(S)]`` with K = embed_dim // 2 columns each.

Host numpy and scipy, as in the JAX package, which runs no device code
for it.  One difference: ARPACK (``svds``, ``eigs``) starts from the
ones vector here, where the JAX package draws a random start, so a run
repeats itself.  The bookkeeping of ``S_perturb`` and ``Sim``, the rerun
test and the sign handling in ``trip`` are the JAX package's, line for
line.  The CSVs hold float64 values, byte-equal to what ``pandas`` writes
for the JAX package's float64 frame.
"""
from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import ArpackError, eigs, svds

from ctgcn_torch.data.formats import (get_sp_adj_mat, read_node_list,
                                      write_embedding_csv, write_time_csv)
from ctgcn_torch.utils import check_and_make_path, resolve_device


def _svds(A, k):
    return svds(A, k, v0=np.ones(min(A.shape)))


def frobenius_obj(Sim, U, V):
    """||S - U V^T||_F^2 without densifying."""
    row, col, val = sp.find(Sim)
    L = float(np.sum(val * val))
    inner = np.sum(U[row] * V[col], axis=1)
    L -= 2.0 * float(np.sum(val * inner))
    L += float(np.sum((U.T @ U) * (V.T @ V)))
    return L


def refine_bound(S_ori, S_add, loss_ori, K):
    """The perturbation lower bound of the loss after ``S_add``."""
    S_temp = S_add + S_ori
    trace_change = (S_temp.dot(S_temp)).diagonal().sum() \
        - (S_ori.dot(S_ori)).diagonal().sum()

    M = S_ori.dot(S_add)
    M = M + M.transpose() + S_add.dot(S_add)
    eigen_num = min(int(np.around(2 * K)), M.shape[0] - 2)
    try:
        vals, _ = eigs(M.astype(np.float64), eigen_num,
                       v0=np.ones(M.shape[0]))
        vals = np.sort(vals.real[vals.real >= 0])[::-1]
    except (ArpackError, ValueError, TypeError):
        # no eigen part of the bound then, as in the JAX package
        vals = np.array([])
    if len(vals) >= K:
        eigen_sum = vals[:K].sum()
    elif len(vals) > 0:
        eigen_sum = vals.sum() + vals[-1] * (K - len(vals))
    else:
        eigen_sum = 0.0
    return loss_ori + trace_change - eigen_sum


def trip(Old_U, Old_S, Old_V, Delta):
    """TRIP eigen-pair update (Chen & Tong, 'Fast eigen-functions tracking
    on dynamic graphs', SDM'15)."""
    N, K = Old_U.shape
    # unify signs so the largest-|x| entry of each eigenvector is positive
    X = Old_U.copy()
    for i in range(K):
        j = np.argmax(np.abs(X[:, i]))
        if X[j, i] < 0:
            X[:, i] = -X[:, i]
    # eigenvalue signs from U/V agreement at the max-U row
    max_idx = np.argmax(Old_U, axis=0)
    temp_v = Old_U[max_idx, np.arange(K)]
    temp_sign = np.sign(temp_v * Old_V[max_idx, np.arange(K)])
    Old_L = np.diag(Old_S) * temp_sign

    temp_sum = np.asarray(X.T @ (Delta @ X))  # [K, K]
    Delta_L = np.diag(temp_sum).copy()

    Delta_X = np.zeros((N, K))
    for i in range(K):
        D = np.diag(np.full(K, Old_L[i] + Delta_L[i]) - Old_L)
        alpha = np.linalg.pinv(D - temp_sum) @ temp_sum[:, i]
        Delta_X[:, i] = X @ alpha

    New_U = X + Delta_X
    norms = np.sqrt(np.sum(New_U * New_U, axis=0))
    norms[norms == 0] = 1.0
    New_U = New_U / norms
    New_S = np.diag(np.abs(Old_L + Delta_L))
    New_V = New_U @ np.diag(np.sign(Old_L + Delta_L))
    return New_U, New_S, New_V


def timers(nodes_file, input_base_path, output_base_path, Theta=0.17,
           dim=128, sep="\t", Update=True):
    """Embed every snapshot under ``input_base_path`` into a CSV of the
    same name under ``output_base_path``.  Returns one dict a snapshot,
    as it prints them: ``file``, ``seconds``, ``loss`` (the updated
    embedding's, before any rerun), ``bound`` (the loss itself at the
    first) and ``rerun`` (whether a full SVD then replaced the update;
    never at the first, which the first SVD embeds)."""
    check_and_make_path(output_base_path)
    full_node_list = read_node_list(nodes_file)
    N = len(full_node_list)
    K = dim
    f_list = sorted(os.listdir(input_base_path))

    def export(U_cur, V_cur, f_name):
        write_embedding_csv(os.path.join(output_base_path, f_name),
                            np.hstack((U_cur, V_cur)), full_node_list,
                            sep=sep, dtype=np.float64)

    t0 = time.time()
    A = get_sp_adj_mat(os.path.join(input_base_path, f_list[0]),
                       full_node_list, sep=sep).tocsr()
    u, s, vt = _svds(A.astype(np.float64), K)
    U, S, V = u, np.diag(s), vt.T
    U_cur = U @ np.sqrt(S)
    V_cur = V @ np.sqrt(S)
    loss = frobenius_obj(A, U_cur, V_cur)
    loss_rerun = loss
    export(U_cur, V_cur, f_list[0])
    out = [{"file": f_list[0], "seconds": time.time() - t0, "loss": loss,
            "bound": loss, "rerun": False}]
    print(f"time = 1, loss = {loss}, loss_bound = {loss}")

    Sim = A.copy()          # similarity at last rerun
    S_cum = A.copy()        # cumulated similarity
    S_perturb = sp.csr_matrix((N, N))

    for i in range(1, len(f_list)):
        t0 = time.time()
        A_cur = get_sp_adj_mat(os.path.join(input_base_path, f_list[i]),
                               full_node_list, sep=sep).tocsr()
        S_add = (A_cur - S_cum).tocsr()
        S_perturb = S_perturb + S_add

        if Update:
            U, S, V = trip(U, S, V, S_add)
            U_cur = U @ np.sqrt(S)
            V_cur = V @ np.sqrt(S)
            loss = frobenius_obj(S_cum + S_add, U_cur, V_cur)
        bound = refine_bound(Sim, S_perturb, loss_rerun, K)
        S_cum = S_cum + S_add
        print(f"time = {i + 1}, loss = {loss}, loss_bound = {bound}")
        row = {"file": f_list[i], "loss": loss, "bound": bound,
               "rerun": bool(loss >= (1 + Theta) * bound)}
        if row["rerun"]:
            print(f"Begin rerun at time stamp: {i + 1}")
            Sim = S_cum.copy()
            S_perturb = sp.csr_matrix((N, N))
            u, s, vt = _svds(Sim.astype(np.float64), K)
            U, S, V = u, np.diag(s), vt.T
            U_cur = U @ np.sqrt(S)
            V_cur = V @ np.sqrt(S)
            loss_rerun = frobenius_obj(Sim, U_cur, V_cur)
            loss = loss_rerun
        export(U_cur, V_cur, f_list[i])
        out.append(dict(row, seconds=time.time() - t0))
    return out


def timers_embedding(args, device="cuda"):
    """TIMERS over every snapshot of the config (``embed_dim // 2``
    singular vectors a side).  It runs on the host whatever ``device``
    says; ``device`` is resolved as for every other method, so ``cuda``
    without a GPU raises.  Returns what ``timers`` returns."""
    resolve_device(device)
    base_path = args["base_path"]
    out = timers(
        os.path.abspath(os.path.join(base_path, args["node_file"])),
        os.path.abspath(os.path.join(base_path, args["origin_folder"])),
        os.path.abspath(os.path.join(base_path, args["embed_folder"])),
        Theta=args["theta"], dim=args["embed_dim"] // 2,
        sep=args.get("file_sep", "\t"), Update=True)
    if args.get("record_time", False):
        write_time_csv(os.path.join(base_path, "TIMERS_time.csv"),
                       [r["seconds"] for r in out])
    return out
