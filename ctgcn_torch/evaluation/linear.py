# coding: utf-8
"""The scikit-learn pieces the evaluators use, in torch on the tensors'
device, in float64.

* :func:`fit_logistic`: binary L2 logistic regression with
  ``class_weight="balanced"`` and an unpenalized intercept, whose argmin is
  ``LogisticRegression(solver="lbfgs")``'s,
  ``C * sum_i sw_i * logloss_i + 0.5 * |w|^2`` with ``sw = n / (2 n_class)``.
  The problem is strictly convex, so Newton's method with a backtracking
  line search reaches the same point; one solve serves every C at once.
* :func:`fit_ovr` / :func:`ovr_proba`: ``OneVsRestClassifier`` over
  ``LabelBinarizer`` indicator columns (one estimator and ``[1 - p, p]``
  for two classes; a column with one value is a constant predictor).
* :func:`ridge_cross_val_predict`: ``cross_val_predict(Ridge(alpha), cv=k)``
  (unshuffled ``KFold``, the first ``n % k`` folds one row longer,
  centered intercept, closed-form solve), for several alphas and targets.
* :func:`roc_auc`, :func:`spearman`, :func:`accuracy`: ``roc_auc_score``,
  pandas' ``corr(method="spearman")`` and ``accuracy_score`` on indicator
  rows.
"""
from __future__ import annotations

import numpy as np
import torch

#: stop when a step moves no weight by more than this, relative to the
#: largest weight (Newton converges quadratically, so the step after one
#: this small changes nothing in float64), or when a step under
#: ``FLOOR_TOL`` shrinks less than half from the last: rounding noise
STEP_TOL, FLOOR_TOL = 1e-9, 1e-6
#: Armijo constant and the most halvings of a step
_ARMIJO, _MAX_HALVINGS = 1e-4, 60


def _logistic_objective(w, Xa, y, sw, C, reg):
    z = w @ Xa.T
    loss = torch.logaddexp(torch.zeros_like(z), z) - y * z
    return C * (loss @ sw) + 0.5 * (w * w * reg).sum(1)


def fit_logistic(X, y, C_list, max_iter=100):
    """Balanced L2 logistic regression of 0/1 labels ``y`` on ``X`` [n, d]
    for every C of ``C_list``: weights [len(C_list), d + 1], the intercept
    last.  At most ``max_iter`` Newton steps."""
    n, d = X.shape
    dt, dev = torch.float64, X.device
    Xa = torch.cat([X.to(dt), torch.ones(n, 1, dtype=dt, device=dev)], 1)
    y = y.to(dt)
    n_pos = float(y.sum())
    if n_pos == 0 or n_pos == n:
        raise ValueError("logistic regression needs samples of 2 classes")
    sw = torch.full_like(y, n / (2 * (n - n_pos)))
    sw[y > 0] = n / (2 * n_pos)
    C = torch.tensor([float(c) for c in C_list], dtype=dt, device=dev)
    reg = torch.ones(d + 1, dtype=dt, device=dev)
    reg[-1] = 0.0
    w = torch.zeros(len(C), d + 1, dtype=dt, device=dev)
    active = torch.ones(len(C), dtype=torch.bool, device=dev)
    last_moved = torch.full_like(C, float("inf"))
    eps = torch.finfo(dt).eps
    for _ in range(max_iter):
        p = torch.sigmoid(w @ Xa.T)                             # [B, n]
        grad = C[:, None] * ((sw * (p - y)) @ Xa) + w * reg
        h = C[:, None] * sw * p * (1 - p)
        hess = (Xa.T * h[:, None, :]) @ Xa + torch.diag(reg)
        step = -torch.linalg.solve(hess, grad) * active[:, None]
        f0 = _logistic_objective(w, Xa, y, sw, C, reg)
        slope = (grad * step).sum(1)
        t = torch.ones_like(C)
        for _ in range(_MAX_HALVINGS):
            f1 = _logistic_objective(w + t[:, None] * step, Xa, y, sw, C,
                                     reg)
            # the slack lets a converged step through rounding noise
            ok = f1 <= f0 + _ARMIJO * t * slope + 4 * eps * f0.abs()
            if bool(ok.all()):
                break
            t = torch.where(ok, t, t / 2)
        w = w + t[:, None] * step
        moved = (t[:, None] * step).abs().amax(1)
        scale = 1 + w.abs().amax(1)
        done = ((moved <= STEP_TOL * scale)
                | ((moved < FLOOR_TOL * scale) & (moved > last_moved / 2)))
        last_moved = moved
        active &= ~done
        if not bool(active.any()):
            break
    return w


def predict_logistic(w, X):
    """P(label 1) [B, n] of weights [B, d + 1] on ``X`` [n, d]."""
    return torch.sigmoid(X.to(w.dtype) @ w[:, :-1].T + w[:, -1]).T


def fit_ovr(X, Y, C_list, max_iter=100):
    """One binary fit per indicator column of ``Y`` [n, k] (a tensor), for
    every C: a list with, per column, weights [B, d + 1] or the column's
    constant value (an int) where it holds one value only."""
    models = []
    for j in range(Y.shape[1]):
        col = Y[:, j]
        values = torch.unique(col)
        if values.numel() == 1:
            models.append(int(values[0]))
        else:
            models.append(fit_logistic(X, col, C_list, max_iter))
    return models


def ovr_proba(models, X, n_c):
    """Class scores [B, n, k] of :func:`fit_ovr` models for ``n_c`` C
    values (``[1 - p, p]`` when there is one column; rows of a single
    column sum to 1 as ``OneVsRestClassifier`` normalizes them)."""
    cols = []
    for m in models:
        if isinstance(m, int):
            cols.append(torch.full((n_c, X.shape[0]), float(m),
                                   dtype=torch.float64, device=X.device))
        else:
            cols.append(predict_logistic(m, X))
    P = torch.stack(cols, -1)
    if len(models) == 1:
        P = torch.cat([1 - P, P], -1)
        P = P / P.sum(-1, keepdim=True)
    return P


def _kfold_bounds(n, folds):
    sizes = [n // folds + (1 if i < n % folds else 0) for i in range(folds)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return [(int(starts[i]), int(starts[i + 1])) for i in range(folds)]


def ridge_cross_val_predict(X, Y, alphas, folds=5):
    """Out-of-fold predictions [len(alphas), n, t] of ridge regressions
    with intercept of each target column of ``Y`` [n, t] on ``X`` [n, d]."""
    X, Y = X.to(torch.float64), Y.to(torch.float64)
    n, d = X.shape
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    a = torch.tensor([float(v) for v in alphas], dtype=X.dtype,
                     device=X.device)
    out = torch.empty(len(alphas), n, Y.shape[1], dtype=X.dtype,
                      device=X.device)
    for lo, hi in _kfold_bounds(n, folds):
        train = torch.cat([X[:lo], X[hi:]])
        ytrain = torch.cat([Y[:lo], Y[hi:]])
        x_mean, y_mean = train.mean(0), ytrain.mean(0)
        Xc, Yc = train - x_mean, ytrain - y_mean
        coef = torch.linalg.solve(Xc.T @ Xc + a[:, None, None] * eye,
                                  (Xc.T @ Yc).expand(len(alphas), d, -1))
        out[:, lo:hi] = (X[lo:hi] - x_mean) @ coef + y_mean
    return out


def average_ranks(x):
    """1-based ranks of a 1-D tensor, ties given their mean rank."""
    order = torch.argsort(x, stable=True)
    xs = x[order]
    new = torch.ones_like(xs, dtype=torch.bool)
    new[1:] = xs[1:] != xs[:-1]
    group = torch.cumsum(new.long(), 0) - 1
    counts = torch.bincount(group)
    first = torch.cumsum(counts, 0) - counts               # 0-based start
    avg = first.to(torch.float64) + (counts.to(torch.float64) + 1) / 2
    ranks = torch.empty_like(avg[group])
    ranks[order] = avg[group]
    return ranks


def roc_auc(y, score):
    """Area under the ROC curve of 0/1 labels ``y`` for ``score``
    (Mann-Whitney with average ranks for ties)."""
    pos = y.reshape(-1) > 0
    n_pos = int(pos.sum())
    n_neg = pos.numel() - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    r = average_ranks(score.reshape(-1).to(torch.float64))
    u = float(r[pos].sum()) - n_pos * (n_pos + 1) / 2
    return u / (n_pos * n_neg)


def spearman(a, b):
    """Spearman correlation of two 1-D tensors over the pairs where neither
    is NaN: Pearson of average ranks (NaN where a side is constant)."""
    a, b = a.reshape(-1).to(torch.float64), b.reshape(-1).to(torch.float64)
    keep = ~(torch.isnan(a) | torch.isnan(b))
    if int(keep.sum()) < 2:
        return float("nan")
    ra, rb = average_ranks(a[keep]), average_ranks(b[keep])
    ra, rb = ra - ra.mean(), rb - rb.mean()
    den = torch.sqrt((ra * ra).sum()) * torch.sqrt((rb * rb).sum())
    if float(den) == 0.0:
        return float("nan")
    return float(torch.clamp((ra * rb).sum() / den, -1.0, 1.0))


def accuracy(Y_true, Y_pred):
    """Share of rows of two indicator tensors that agree in every column."""
    return float((Y_true == Y_pred).all(1).to(torch.float64).mean())
