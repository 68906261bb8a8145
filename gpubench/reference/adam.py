"""The reference's optimizer steps for a job whose step is its own: Adam
over the leaves, as ``train.follow`` runs it, around the job's step."""
from __future__ import annotations

import torch


def follow_steps(params0, job, steps, step):
    """``len(steps)`` steps of ``torch.optim.Adam`` (the job's lr and L2
    weight decay, eps 1e-8) from ``params0`` ({name: tensor}), each after
    ``step(params, batches)``, which adds the step's loss gradient to the
    leaves' ``.grad`` and returns the step's loss as a float.  Returns what
    ``train.follow`` returns: (losses, {leaf: norm of the first step's
    gradient}, {leaf: norm of the change after the last step}), the norms
    in float64."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=job["lr"],
                           weight_decay=job["weight_decay"], eps=1e-8)
    losses, grad1 = [], None
    for s, batches in enumerate(steps):
        opt.zero_grad(set_to_none=False)
        losses.append(step(params, batches))
        if s == 0:
            grad1 = {k: float(p.grad.double().norm())
                     for k, p in params.items()}
        opt.step()
    delta = {k: float((params[k].detach().double()
                       - params0[k].double()).norm()) for k in params}
    return losses, grad1, delta
