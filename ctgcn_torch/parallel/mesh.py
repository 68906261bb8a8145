# coding: utf-8
"""Time sharding of the CTGCN family and the gradient rule of every
partitioned path (port of ``embedding_shardings`` and
``make_ctgcn_train_step`` in ``ctgcn_tpu/parallel/mesh.py``).

Time sharding (config ``n_devices``): part r owns the contiguous chunk
[r·T/P, (r+1)·T/P) of the window's timesteps.  It keeps only its slice of
the time-stacked containers (``mlps``, ``cdns``, ``gcns``: one module a
timestep) and only its snapshots' pyramids, which the loader builds on the
backend one device would choose for the whole window.  The JAX package
pads every snapshot's blocks to one shape (``uniform_blocks``) so that
``vmap`` can shard the [T] axis; here each snapshot keeps its own ragged
blocks, and nothing needs that padding.  The part's own MLP + CDN run on
its timesteps; an all-gather over T feeds the time RNN, the LayerNorm and
the loss, which every part computes whole.

Every part builds the whole model from the config's seed and keeps its
slice, so the sharded model is the single-device model, and
``state_dict`` gives the single-device model file.

The gradient rule (``Sharding.reduce_grads``), for a loss that every part
computes whole from gathered tensors:
  * the gather's backward takes the part's own slice (``dist.gather_own``);
  * replicated parameters used before the gather (CGCN's shared MLP / CDN,
    every weight of the halo paths) hold this part's share: summed;
  * parameters used only after it (CTGCN's time RNN and norm) hold the
    whole gradient on every part: averaged, only to keep the parts'
    copies bit-identical;
  * a time-stacked parameter lives on one part and keeps its gradient.
Adam then runs on each part over what that part holds.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.distributed as dist

from ctgcn_torch.nn.core_models import CTGCN
from ctgcn_torch.ops.pyramid import CorePyramid
from ctgcn_torch.ops.rnn import rnn_scan
from ctgcn_torch.parallel.dist import Parts, all_reduce_grads, gather_own

#: containers with one module a timestep
STACKED = ("mlps", "cdns", "gcns")
#: CTGCN's parameters used after the gather over T
AFTER_GATHER = ("rnn", "norm")


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
    for name in STACKED:
        mods = getattr(model, name, None)
        if isinstance(mods, nn.ModuleList):
            setattr(model, name, nn.ModuleList(list(mods)[lo:hi]))
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
    """What the engine does for a model split over ``parts``: reduce the
    gradients by the rule above, and read and write the whole model file.

    kind: "time" (time-stacked containers split, ``time_length`` T) or
    "graph" (every parameter replicated, rows split)."""

    def __init__(self, parts: Parts, kind, time_length=None):
        if kind not in ("time", "graph"):
            raise ValueError(f"kind {kind!r}")
        self.parts = parts
        self.kind = kind
        self.time_length = time_length

    def _split(self, model):
        """(summed, averaged) parameters; time-stacked ones are in
        neither."""
        summed, averaged = [], []
        for name, p in model.named_parameters():
            top = name.split(".")[0]
            if self.kind == "time" and top in STACKED:
                continue
            if isinstance(model, CTGCN) and top in AFTER_GATHER:
                averaged.append(p)
            else:
                summed.append(p)
        return summed, averaged

    def reduce_grads(self, model):
        summed, averaged = self._split(model)
        all_reduce_grads(summed, self.parts)
        all_reduce_grads(averaged, self.parts, average=True)

    def state_dict(self, model):
        """The whole model's ``state_dict``, keys and order as one device
        would have them (a collective: every part calls it).  Under time
        sharding each timestep's tensors come from the part that owns it;
        the replicated ones are the same on every part."""
        if self.kind == "graph":
            return model.state_dict()
        lo, _ = time_chunk(self.parts, self.time_length)
        per = self.time_length // self.parts.count
        out = {}
        for name, child in model.named_children():
            if name not in STACKED or not isinstance(child, nn.ModuleList):
                out.update(child.state_dict(prefix=f"{name}."))
                continue
            template = child[0].state_dict()
            for t in range(self.time_length):
                owner = t // per
                mine = child[t - lo].state_dict() if owner == \
                    self.parts.index else None
                for sub, ref in template.items():
                    buf = (mine[sub].clone() if mine is not None
                           else torch.empty_like(ref))
                    if not self.parts.local:
                        dist.broadcast(buf, src=owner, group=self.parts.group)
                    out[f"{name}.{t}.{sub}"] = buf
        return out

    def load_state_dict(self, model, state):
        """Load the whole model's ``state_dict`` into this part's slice."""
        if self.kind == "graph":
            model.load_state_dict(state)
            return
        lo, hi = time_chunk(self.parts, self.time_length)
        local = {}
        for key, val in state.items():
            top, _, rest = key.partition(".")
            if top in STACKED:
                t, _, sub = rest.partition(".")
                if lo <= int(t) < hi:
                    local[f"{top}.{int(t) - lo}.{sub}"] = val
            else:
                local[key] = val
        model.load_state_dict(local)
