"""U-neg: each epoch's node batches through the window's forward and the
negative-sampling loss over the walk partners, one Adam step an epoch.

Program side: the engine call, the model's leaves, the recorder of the
checked steps (per batch the batch ids and mask and the loss's draws,
``losses.sample_uneg``'s partner slots and negatives; the first batch's
embeddings; the sampling table the negatives are drawn from), the
window's negatives, kept as drawn, the markers around the loss
(``driver.negative_sampling_loss``, forward and backward) and the
half-batch fault.  Reference side: the walk tables
worked out again from the data and the walk seeds, their comparison with
the program's files, the draws checked on their own, and the steps
followed."""
from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import scipy.sparse as sp
import torch

from program import PACKAGE, patched
from reference import train, uneg, walks


def param_spec(model, cfg, n):
    return model.param_spec(cfg, n)


def leaves(trainer):
    return dict(trainer.model.named_parameters())


def learn(trainer, args, epochs, seed):
    """One ``learn_embedding`` call of ``epochs`` epochs, unexported."""
    return trainer.learn_embedding(
        epoch=epochs, batch_size=args["batch_size"], lr=args["lr"],
        weight_decay=args["weight_decay"], model_file=None, export=False,
        shuffle=args["shuffle"], seed=int(seed), verbose=False)


@contextlib.contextmanager
def recorder(log):
    """Append one dict per batch to ``log["batches"]`` while inside, and
    keep the first sampling table as ``log["neg_logits"]``."""
    batches = log.setdefault("batches", [])
    pending = {}

    def make_sample(orig):
        def sample_uneg(walk, batch_idx, neg_num, generator):
            j, neg = orig(walk, batch_idx, neg_num, generator)
            pending.update(batch=batch_idx.clone(), j=j.clone(),
                           neg=neg.clone())
            if "neg_logits" not in log:
                log["neg_logits"] = walk.neg_logits.detach().cpu()
            return j, neg
        return sample_uneg

    def make_loss(orig):
        def negative_sampling_loss(embs, batch_idx, batch_mask, walk,
                                   generator, **kw):
            out = orig(embs, batch_idx, batch_mask, walk, generator, **kw)
            rec = dict(pending, mask=batch_mask.clone())
            if not batches:
                log["embs"] = embs.detach().cpu()
            batches.append(rec)
            pending.clear()
            return out
        return negative_sampling_loss

    with patched(f"{PACKAGE}.losses", "sample_uneg", make_sample), \
            patched(f"{PACKAGE}.training.driver", "negative_sampling_loss",
                    make_loss):
        yield


@contextlib.contextmanager
def watch(log):
    """Keep each of the window's negative draws ([T, S], the tensor the
    program made) in ``log["negs"]``."""
    negs = log.setdefault("negs", [])

    def make_sample(orig):
        def sample_uneg(walk, batch_idx, neg_num, generator):
            j, neg = orig(walk, batch_idx, neg_num, generator)
            negs.append(neg)
            return j, neg
        return sample_uneg

    with patched(f"{PACKAGE}.losses", "sample_uneg", make_sample):
        yield


def records(log, steps):
    """The checked steps' batches on the host, ``steps`` lists of them."""
    host = [{k: v.cpu() for k, v in b.items()} for b in log["batches"]]
    per = len(host) // steps
    return {"steps": [host[i * per:(i + 1) * per] for i in range(steps)],
            "embs": log["embs"], "neg_logits": log["neg_logits"]}


class _Open(torch.autograd.Function):
    """Identity; its backward, the first of the loss's, opens the range."""
    hook = None

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _Open.hook[0]("loss")
        return g


class _Close(torch.autograd.Function):
    """Identity on the embeddings; its backward, the last of the loss's,
    closes the range."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _Open.hook[1]("loss")
        return g


@contextlib.contextmanager
def trace_ranges(ranges):
    """Bracket the loss's forward and its backward with markers."""
    open_, close = ranges
    _Open.hook = ranges

    def make(orig):
        def negative_sampling_loss(embs, *a, **kw):
            open_("loss")
            out = _Open.apply(orig(_Close.apply(embs), *a, **kw))
            close("loss")
            return out
        return negative_sampling_loss

    with patched(f"{PACKAGE}.training.driver", "negative_sampling_loss",
                 make):
        yield


@contextlib.contextmanager
def half():
    """Each batch's loss leaves out the second half of its rows and takes
    the mean over the rest."""
    def make(orig):
        def negative_sampling_loss(embs, b_idx, b_mask, *a, **kw):
            keep = b_mask.clone()
            keep[b_mask.shape[0] // 2:] = False
            return orig(embs, b_idx, keep, *a, **kw)
        return negative_sampling_loss

    with patched(f"{PACKAGE}.training.driver", "negative_sampling_loss",
                 make):
        yield


# ---- reference side -------------------------------------------------------

def _tables(adjs, traffic, seed, device):
    """(tables on the device, [(pairs, counts)] a snapshot) from the
    reference's own walks."""
    p = traffic["program"]
    host = [walks.tables(walks.walks(a, p["walk_length"], p["walk_time"],
                                     walks.snapshot_seed(seed, i)),
                         a.shape[0])
            for i, a in enumerate(adjs)]
    return uneg.Tables([h[0] for h in host], [h[1] for h in host],
                       device), host


def _walk_mismatch(args, host):
    """Snapshots whose pair file or negative-sampling list, as the
    program's preprocessing wrote them, differ from the reference's."""
    pair_dir = os.path.join(args["base_path"], args["walk_pair_folder"])
    freq_dir = os.path.join(args["base_path"], args["node_freq_folder"])
    pair_files, freq_files = sorted(os.listdir(pair_dir)), sorted(
        os.listdir(freq_dir))
    bad = abs(len(pair_files) - len(host)) + abs(len(freq_files) - len(host))
    for pf, ff, (pairs, counts) in zip(pair_files, freq_files, host):
        got = sp.load_npz(os.path.join(pair_dir, pf)).tocsr()
        with open(os.path.join(freq_dir, ff)) as fp:
            listed = np.bincount(np.asarray(json.load(fp), np.int64),
                                 minlength=counts.shape[0])
        if got.shape != pairs.shape or ((got != 0) != (pairs != 0)).nnz \
                or not np.array_equal(listed, counts):
            bad += 1
    return bad


def _draw_faults(tabs, steps, n_nodes, neg_logits, window_negs):
    """The draws checked on their own: each batch's partner slots and
    negatives (``uneg.draw_faults``), each step's batches, which have to
    hold every node once, the sampling table, and the fit to their rules
    of the slots of the checked steps and of the negatives of the checked
    steps and the window.  (faults, {statistic: value})."""
    bad = 0
    for batches in steps:
        for b in batches:
            bad += uneg.draw_faults(tabs, b["batch"], b["j"], b["neg"])
        ids = torch.cat([b["batch"][b["mask"]] for b in batches]).sort().values
        if ids.numel() != n_nodes or not torch.equal(
                ids, torch.arange(n_nodes, device=ids.device)):
            bad += 1
    every = [b for batches in steps for b in batches]
    negs = [b["neg"] for b in every] + [n.to(tabs.counts[0].device)
                                        for n in window_negs]
    bad += sum(int((c[n[t]] <= 0).sum()) for n in window_negs
               for t, c in enumerate(tabs.counts))
    stats = {"table_mismatch": uneg.table_mismatch(tabs, neg_logits),
             "negatives": sum(n.numel() for n in negs),
             "negative_z": uneg.negative_fit(tabs, negs),
             "slot_z": uneg.slot_fit(tabs, every)}
    bad += (stats["table_mismatch"] + int(abs(stats["negative_z"])
                                          > uneg.Z_LIMIT)
            + int(abs(stats["slot_z"]) > uneg.Z_LIMIT))
    return bad, stats


def reference_inputs(cell, adjs, seed, device, prog, steps):
    """The walk tables, ``walk_mismatch`` and the draws' faults."""
    tabs, host = _tables(adjs, cell.traffic, seed, device)
    faults, stats = _draw_faults(tabs, steps, prog["n"],
                                 prog["records"]["neg_logits"],
                                 prog.get("watched", {}).get("negs", []))
    return tabs, {"walk_mismatch": _walk_mismatch(prog["args"], host),
                  "draw_faults": faults}, stats


def follow(model, cfg, traffic, prep, tabs, params0, steps):
    return train.follow(model, cfg, traffic["program"], prep, tabs, params0,
                        steps)


def flops(model, prep, cfg, traffic):
    """FLOPs of one epoch: every batch runs the window's forward and
    backward and its loss."""
    p = traffic["program"]
    n_batch = -(-prep.n // p["batch_size"])
    f, b = model.flops(prep, cfg)
    lf, lb = uneg.flops(n_batch, cfg["duration"], p["batch_size"],
                        p["neg_num"], cfg["embed_dim"])
    return n_batch * (f + b) + lf + lb
