"""The reference's training steps and the numbers compared with the
program's.

A step is what the program's epoch is: the U-neg loss of every node batch
added up (the gradient of the sum), then one ``torch.optim.Adam`` step
(L2 weight decay added to the gradient, eps 1e-8).  Where the batches
carry no draws of the forward, the window's forward runs once a step and
the batches' losses are summed; where they do (``b["draws"]``, such as
dropout masks), once a batch under that batch's draws.
"""
from __future__ import annotations

import torch

from reference import uneg


def follow(model, cfg, job, prep, tabs, params0, records):
    """Run ``len(records)`` steps from ``params0`` ({name: tensor}).
    ``records[s]``: the step's batches, each a dict of ``batch``, ``mask``,
    ``j``, ``neg`` and, for a model that draws in its forward, ``draws``
    (the forward's keyword arguments).  Returns
    (losses [steps], {leaf: norm of the first step's loss gradient},
    {leaf: norm of the parameters' change after the last step}), the norms
    in float64."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=job["lr"],
                           weight_decay=job["weight_decay"], eps=1e-8)
    losses, grad1 = [], None
    for s, batches in enumerate(records):
        opt.zero_grad(set_to_none=False)
        total = 0.0
        if "draws" not in batches[0]:
            embs = model.forward(params, prep, cfg)
            step_loss = sum(uneg.loss(embs, b["batch"], b["mask"], tabs,
                                      b["j"], b["neg"], job["Q"])
                            for b in batches)
            step_loss.backward()
            total = float(step_loss.detach())
            del embs, step_loss
        else:
            for b in batches:
                embs = model.forward(params, prep, cfg, **b["draws"])
                lb = uneg.loss(embs, b["batch"], b["mask"], tabs, b["j"],
                               b["neg"], job["Q"])
                lb.backward()
                total += float(lb.detach())
                del embs, lb
        if s == 0:
            grad1 = {k: float(p.grad.double().norm())
                     for k, p in params.items()}
        opt.step()
        losses.append(total)
    delta = {k: float((params[k].detach().double()
                       - params0[k].double()).norm()) for k in params}
    return losses, grad1, delta


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                    + v[len(v) // 2])


def gaps(got, ref):
    """The numbers compared, each a worst case over steps or leaves:
    loss_gap, |loss - ref| / |ref| over the steps; grad_gap, the gap of a
    leaf's first-step gradient norm from the reference's over the larger
    of that leaf's reference norm and the median leaf's; step_gap, the
    same of the parameters' change, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (below it a
    leaf moves under Adam by round-off alone).  ``got``/``ref``: what
    ``follow`` returns.  Also the leaf each worst case came from."""
    (l_got, g_got, d_got), (l_ref, g_ref, d_ref) = got, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_got, l_ref))
    med_g = _median(g_ref.values())
    grad = {k: abs(g_got[k] - g_ref[k]) / max(g_ref[k], med_g) for k in g_ref}
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    med_d = _median(d_ref[k] for k in moved)
    step = {k: abs(d_got[k] - d_ref[k]) / max(d_ref[k], med_d) for k in moved}
    gk, sk = max(grad, key=grad.get), max(step, key=step.get)
    return ({"loss_gap": loss_gap, "grad_gap": grad[gk], "step_gap": step[sk]},
            {"grad_gap": gk, "step_gap": sk,
             "left_out": sorted(set(g_ref) - set(moved))})
