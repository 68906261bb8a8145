"""The posterior's noise of VGRNN's snapshots (``nn.vgrnn._noise``), one
[N, embed] draw a call, in call order, kept on the host (at Enron 45 MB a
draw, 2 GB over three checked steps of three batches: more than the
window should hold on the card).  Each call is checked on its own against
a standard normal: over its m entries, the mean's distance from 0, mean *
sqrt(m), and the variance's from 1, (var - 1) * sqrt(m / 2), each in
standard deviations; and against every other call: their correlation
times sqrt(m), which two independent draws give as a standard normal and
a repeated (or negated) draw as sqrt(m).  Each over 6 a fault."""
from __future__ import annotations

import contextlib
import math

import torch

from program import PACKAGE, patched

Z_LIMIT = 6.0
#: entries of each draw taken at a time into the host product of the
#: draws' pairs
COLUMNS = 1 << 20


def pair_z(draws):
    """[calls, calls] float64: each pair's correlation (about 0, each
    entry's standard deviation 1) times sqrt(m); the diagonal is zeroed."""
    flat = [x.reshape(-1) for x in draws]
    m = flat[0].numel()
    gram = torch.zeros(len(flat), len(flat), dtype=torch.float64)
    for c0 in range(0, m, COLUMNS):
        part = torch.stack([x[c0:c0 + COLUMNS] for x in flat]).double()
        gram += part @ part.T
    norm = gram.diagonal().sqrt()
    z = gram / torch.outer(norm, norm) * math.sqrt(m)
    return z.fill_diagonal_(0.0)


class Recorder(contextlib.ExitStack):
    def __init__(self):
        super().__init__()
        self.noise = []
        #: (the mean's z, the variance's z, the largest |z| of its
        #: correlation with another call), one a call
        self.stats = []

    def __enter__(self):
        super().__enter__()
        self.enter_context(patched(f"{PACKAGE}.nn.vgrnn", "_noise",
                                   self._wrap))
        return self

    def _wrap(self, orig):
        def _noise(n, d, generator, like):
            out = orig(n, d, generator, like)
            x = out.detach().double()
            m = x.numel()
            self.stats.append((float(x.mean()) * math.sqrt(m),
                               (float(x.var()) - 1.0) * math.sqrt(m / 2.0)))
            self.noise.append(out.detach().cpu())
            return out
        return _noise

    def attach(self, steps):
        """Each batch's draws, in call order, as ``b["draws"]["noise"]``;
        the count of calls that break a rule, and of pairs that do."""
        batches = [b for step in steps for b in step]
        per = len(self.noise) // max(len(batches), 1)
        for k, b in enumerate(batches):
            b.setdefault("draws", {})["noise"] = \
                self.noise[k * per:(k + 1) * per]
        corr = (pair_z(self.noise).abs() if len(self.noise) > 1
                else torch.zeros(len(self.noise), len(self.noise)))
        worst = corr.max(1).values.tolist() if self.noise else []
        self.stats = [s + (w,) for s, w in zip(self.stats, worst)]
        bad = sum(int(abs(a) > Z_LIMIT) + int(abs(v) > Z_LIMIT)
                  for a, v, _ in self.stats)
        pairs = int((corr > Z_LIMIT).sum()) // 2
        return bad + pairs + int(per * len(batches) != len(self.noise))
