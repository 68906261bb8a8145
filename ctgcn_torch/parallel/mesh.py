# coding: utf-8
"""Time sharding of the family and the zoo, and the gradient rule of
every partitioned path (port of ``embedding_shardings`` and
``make_ctgcn_train_step`` in ``ctgcn_tpu/parallel/mesh.py``).

Time sharding (config ``n_devices``): part r owns the contiguous chunk
[r·T/P, (r+1)·T/P) of the window's timesteps.  It keeps only its slice of
the model's time-stacked containers (the ``stacked`` of the model's
``time_rule``, a ``nn.layers.TimeRule``: one module a timestep) and only
its snapshots' inputs (the family's pyramids, which the loader builds on
the backend one device would choose for the whole window; the zoo's graphs
and PGNN's proximity matrices).  The JAX package pads every snapshot's
blocks to one shape (``uniform_blocks``) so that ``vmap`` can shard the
[T] axis; here each snapshot keeps its own ragged blocks, and nothing
needs that padding.  The part runs its own snapshots; an all-gather over T
feeds what follows (the time RNN and the LayerNorm of CTGCN and GCRN) and
the loss, which every part computes whole.  EvolveGCN and VGRNN are
sequential in time (their weights, or their hidden state, run from step to
step), so no part can run its snapshots alone: the driver runs them on one
part.

Every part builds the whole model from the config's seed and keeps its
slice, so the sharded model is the single-device model, and
``state_dict`` gives the single-device model file.  A part draws what one
device draws (dropout masks, SAGE's samples, PGNN's anchors), in the same
order, and keeps its own snapshots' draws (``nn.gcn.per_snapshot``).

The gradient rule (``Sharding.reduce_grads``), for a loss that every part
computes whole from gathered tensors:
  * the gather's backward takes the part's own slice (``dist.gather_own``);
  * replicated parameters used before the gather (CGCN's shared MLP / CDN,
    the weights of the per-snapshot zoo methods, every weight of the halo
    paths, CTGCN's time RNN and norm under ``temporal_pipeline``) hold
    this part's share: summed;
  * parameters used only after it (the rule's ``after_gather``: CTGCN's
    and GCRN's time RNN and norm, a supervised classifier) hold the whole
    gradient on every part: averaged, only to keep the parts' copies
    bit-identical;
  * a time-stacked parameter lives on one part and keeps its gradient.
Adam then runs on each part over what that part holds.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.distributed as dist

from ctgcn_torch.nn.core_models import CTGCN
from ctgcn_torch.nn.layers import TimeRule
from ctgcn_torch.ops.pyramid import CorePyramid
from ctgcn_torch.ops.rnn import rnn_scan
from ctgcn_torch.parallel.dist import Parts, all_reduce_grads, gather_own


def time_rule(model):
    """The ``TimeRule`` ``model`` declares (none: every weight shared by
    the snapshots, as in CGCN and the per-snapshot zoo methods)."""
    return getattr(model, "time_rule", TimeRule())


def time_chunk(parts: Parts, time_length):
    """(first, end) timestep of this part's chunk; P divides T."""
    if time_length % parts.count:
        raise ValueError(f"{parts.count} parts do not divide T = "
                         f"{time_length}")
    per = time_length // parts.count
    return parts.index * per, (parts.index + 1) * per


def shard_time(model, parts: Parts, time_length):
    """Keep this part's slice of ``model``'s time-stacked containers (in
    place; the model came whole from the config's seed)."""
    lo, hi = time_chunk(parts, time_length)
    for name in time_rule(model).stacked:
        setattr(model, name, nn.ModuleList(list(getattr(model, name))[lo:hi]))
    return model


def time_sharded_forward(model, xs, pyramids: CorePyramid, parts: Parts):
    """CGCN / CTGCN window forward under time sharding: xs (this part's
    [T/P, N, in], or None) and ``pyramids`` (this part's stacked
    snapshots) through the part's MLP + CDN, the parts' outputs gathered
    over T, then CTGCN's time RNN and LayerNorm.  Returns [T, N, out], or
    (embs, trans) for 'S', on every part."""
    if isinstance(model, CTGCN):
        res = model.per_timestep(xs, pyramids)
    else:
        res = model(xs, pyramids)
    s_variant = model.model_type == "S"
    hx = gather_own(res[0] if s_variant else res, parts)
    if isinstance(model, CTGCN):
        outs, _ = rnn_scan(model.rnn, hx)
        hx = model.norm(outs)
    return (hx, gather_own(res[1], parts)) if s_variant else hx


class Sharding:
    """What the engines do for a model split over ``parts``: reduce the
    gradients by the rule above, and read and write the whole model file.

    kind: "time" (the model's ``time_rule``: its stacked containers split
    over ``time_length`` T; ``pipeline`` for ``temporal_pipeline``, where
    the time RNN and norm run before the gather) or "graph" (rows split,
    every parameter replicated: summed, but for those used after the
    gather)."""

    KINDS = ("time", "graph")

    def __init__(self, parts: Parts, kind, time_length=None, pipeline=False):
        if kind not in self.KINDS:
            raise ValueError(f"kind {kind!r}")
        self.parts = parts
        self.kind = kind
        self.time_length = time_length
        self.pipeline = pipeline

    def _rule(self, model):
        """The model's ``TimeRule``: under the pipeline nothing comes after
        the gather; on the halo paths nothing is stacked, and CTGCN's time
        RNN and norm still run after the gather (of the rows)."""
        rule = time_rule(model)
        if self.pipeline:
            return TimeRule(rule.stacked)
        return rule if self.kind == "time" else TimeRule(
            after_gather=rule.after_gather)

    def _split(self, model):
        """(summed, averaged) parameters; time-stacked ones are in
        neither."""
        rule = self._rule(model)
        summed, averaged = [], []
        for name, p in model.named_parameters():
            top = name.split(".")[0]
            if top in rule.stacked:
                continue
            if top in rule.after_gather:
                averaged.append(p)
            else:
                summed.append(p)
        return summed, averaged

    def reduce_grads(self, model, *after):
        """Reduce ``model``'s gradients by the rule, and average those of
        ``after`` (modules used after the gather: a classifier)."""
        summed, averaged = self._split(model)
        averaged += [p for m in after for p in m.parameters()]
        all_reduce_grads(summed, self.parts)
        all_reduce_grads(averaged, self.parts, average=True)

    def state_dict(self, model):
        """The whole model's ``state_dict``, keys and order as one device
        would have them (a collective: every part calls it).  Under time
        sharding each timestep's tensors come from the part that owns it;
        the replicated ones are the same on every part."""
        local = model.state_dict()
        stacked = self._rule(model).stacked
        if not stacked:
            return local
        lo, _ = time_chunk(self.parts, self.time_length)
        per = self.time_length // self.parts.count
        out, done = {}, set()
        for key, val in local.items():
            top = key.partition(".")[0]
            if top not in stacked:
                out[key] = val
                continue
            if top in done:
                continue
            done.add(top)
            template = getattr(model, top)[0].state_dict()
            for t in range(self.time_length):
                owner = t // per
                for sub, ref in template.items():
                    buf = (local[f"{top}.{t - lo}.{sub}"].clone()
                           if owner == self.parts.index
                           else torch.empty_like(ref))
                    if not self.parts.local:
                        dist.broadcast(buf, src=owner, group=self.parts.group)
                    out[f"{top}.{t}.{sub}"] = buf
        return out

    def load_state_dict(self, model, state):
        """Load the whole model's ``state_dict`` into this part's slice."""
        if self.kind != "time":
            model.load_state_dict(state)
            return
        stacked = self._rule(model).stacked
        lo, hi = time_chunk(self.parts, self.time_length)
        local = {}
        for key, val in state.items():
            top, _, rest = key.partition(".")
            if top in stacked:
                t, _, sub = rest.partition(".")
                if lo <= int(t) < hi:
                    local[f"{top}.{int(t) - lo}.{sub}"] = val
            else:
                local[key] = val
        model.load_state_dict(local)
