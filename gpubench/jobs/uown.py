"""U-own (VGRNN): each epoch's node batches through the window's forward
and the VAE loss, which ignores the batch, so that every batch adds the
whole window's loss; the hidden state h starts each epoch at zeros and
crosses its batches detached; one Adam step an epoch.

Program side: the engine call, the model's leaves, the recorder of the
checked steps (one record a batch, the first batch's embeddings and,
from the trainer, the convolutions' graphs
``training.driver`` built, ``data["vgrnn_adjs"]``), the markers around
the loss (``driver.vae_loss``, forward and backward) and the half fault,
the loss over half of the snapshots. The posterior's noise is the
recorder ``draws/noise.py``'s. The recorder also keeps the first batch's
calls of the dense softplus sum (``losses.softplus_gram_sum``, one a
snapshot): z, the sum, the gradient it was given and the dz it returned.
Reference side: the convolutions' graphs checked against the reference's
own; each kept call against the reference's sum and dz at the same z
(``gram_faults``: the gaps over the cell's ``gram_limits``, and a count of
calls other than one a snapshot), which sees the precision of the Gram's
GEMMs where the norms compared after the steps do not; and the steps
followed with the stateful protocol."""
from __future__ import annotations

import contextlib

import torch

from jobs.uneg import _Open
from program import PACKAGE, patched
from reference import adam

#: the log of the checked call while its recorder is open
_LOG = []


def param_spec(model, cfg, n):
    return model.param_spec(cfg, n)


def leaves(trainer):
    return dict(trainer.model.named_parameters())


def learn(trainer, args, epochs, seed):
    """One ``learn_embedding`` call of ``epochs`` epochs, unexported; under
    the recorder it also keeps the trainer's convolution graphs."""
    if _LOG and "conv_adjs" not in _LOG[-1]:
        _LOG[-1]["conv_adjs"] = [
            (g.rows.cpu().numpy(), g.cols.cpu().numpy(), g.vals.cpu().numpy())
            for g in trainer.data["vgrnn_adjs"]]
    return trainer.learn_embedding(
        epoch=epochs, batch_size=args["batch_size"], lr=args["lr"],
        weight_decay=args["weight_decay"], model_file=None, export=False,
        shuffle=args["shuffle"], seed=int(seed), verbose=False)


class _Tap(torch.autograd.Function):
    """Identity on ``x`` that keeps, on the host, the gradient its backward
    passes as ``call[key]``."""

    @staticmethod
    def forward(ctx, x, call, key):
        ctx.call, ctx.key = call, key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.call[ctx.key] = g.detach().cpu()
        return g, None, None


@contextlib.contextmanager
def recorder(log):
    """Append one dict per loss call to ``log["batches"]`` while inside,
    keep the first call's embeddings (its posterior means) as
    ``log["embs"]`` and its dense softplus sums as ``log["gram"]``."""
    batches = log.setdefault("batches", [])
    grams = log.setdefault("gram", [])

    def make(orig):
        def vae_loss(enc_mean, *a, **kw):
            if not batches:
                log["embs"] = enc_mean.detach().cpu()
            batches.append({})
            return orig(enc_mean, *a, **kw)
        return vae_loss

    def make_gram(orig):
        def softplus_gram_sum(z):
            if len(batches) != 1:
                return orig(z)
            call = {"z": z.detach().cpu()}
            grams.append(call)
            out = orig(_Tap.apply(z, call, "dz"))
            call["sum"] = out.detach()
            return _Tap.apply(out, call, "g")
        return softplus_gram_sum

    _LOG.append(log)
    try:
        with patched(f"{PACKAGE}.training.driver", "vae_loss", make), \
                patched(f"{PACKAGE}.losses", "softplus_gram_sum", make_gram):
            yield
    finally:
        _LOG.remove(log)


def watch(log):
    """Nothing of the window's draws is kept: its noise alone is 45 MB a
    snapshot and a batch."""
    del log
    return contextlib.nullcontext()


def records(log, steps):
    per = len(log["batches"]) // steps
    gram = [{"z": c["z"], "sum": float(c["sum"]), "g": float(c["g"]),
             "dz": c["dz"]} for c in log["gram"] if "dz" in c]
    return {"steps": [log["batches"][i * per:(i + 1) * per]
                      for i in range(steps)],
            "embs": log["embs"], "conv_adjs": log["conv_adjs"],
            "gram": gram}


class _CloseAll(torch.autograd.Function):
    """Identity on the loss's five inputs: one node, the last of the
    loss's backward, which closes the range U-neg's ``_Open`` opened."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        _Open.hook[1]("loss")
        return gs


@contextlib.contextmanager
def trace_ranges(ranges):
    """Bracket the loss's forward and its backward with markers."""
    open_, close = ranges
    _Open.hook = ranges

    def make(orig):
        def vae_loss(em, es, pm, ps, z, *a, **kw):
            open_("loss")
            out = _Open.apply(orig(*_CloseAll.apply(em, es, pm, ps, z), *a,
                                   **kw))
            close("loss")
            return out
        return vae_loss

    with patched(f"{PACKAGE}.training.driver", "vae_loss", make):
        yield


@contextlib.contextmanager
def half():
    """The loss over the first half of the snapshots."""
    def make(orig):
        def vae_loss(em, es, pm, ps, z, targets, *a, **kw):
            k = len(targets) // 2
            return orig(em[:k], es[:k], pm[:k], ps[:k], z[:k], targets[:k],
                        *a, **kw)
        return vae_loss

    with patched(f"{PACKAGE}.training.driver", "vae_loss", make):
        yield


# ---- reference side -------------------------------------------------------

def reference_inputs(cell, adjs, seed, device, prog, steps):
    """No tables; ``conv_mismatch`` and ``gram_faults``; the noise draws'
    largest statistics and the Gram's largest gaps."""
    del seed, steps
    stats = prog.get("draw_stats", [])
    gaps = cell.model.gram_gaps(prog["records"]["gram"], device)
    lim = cell.spec["gram_limits"]
    faults = sum(int(not s <= lim["sum_gap"]) + int(not g <= lim["grad_gap"])
                 for s, g in gaps) + int(len(gaps) != cell.cfg["duration"])
    return None, {"conv_mismatch": cell.model.conv_mismatch(
        adjs, prog["records"]["conv_adjs"]), "gram_faults": faults}, {
        "noise_calls": len(stats),
        "noise_mean_z": max((abs(m) for m, _, _ in stats), default=0.0),
        "noise_var_z": max((abs(v) for _, v, _ in stats), default=0.0),
        "noise_pair_z": max((c for _, _, c in stats), default=0.0),
        "gram_sum_gap": max((s for s, _ in gaps), default=0.0),
        "gram_grad_gap": max((g for _, g in gaps), default=0.0)}


def follow(model, cfg, traffic, prep, tables, params0, steps):
    """The steps of the engine's stateful protocol: in each, h from zeros,
    every batch the whole window's VAE loss under its own noise (its
    gradient added up), h carried to the next batch detached, then one
    Adam step (``adam.follow_steps``)."""
    del tables

    def step(params, batches):
        h, total = None, 0.0
        for b in batches:
            outs, h = model.run(params, prep, cfg, b["draws"]["noise"], h)
            loss = model.vae_loss(outs, prep, cfg)
            loss.backward()
            total += float(loss.detach())
            h = h.detach()
            del outs, loss
        return total

    return adam.follow_steps(params0, traffic["program"], steps, step)


def flops(model, prep, cfg, traffic):
    """FLOPs of one epoch: every batch runs the window's forward, its loss
    and their backward."""
    n_batch = -(-prep.n // traffic["program"]["batch_size"])
    f, b = model.flops(prep, cfg)
    return n_batch * (f + b)
