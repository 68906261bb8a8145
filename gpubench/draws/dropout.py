"""The dropout masks of the zoo's GCN layers (``nn.gcn._dropout``), one a
call, in call order; and each call checked on its own: every output entry
is either 0 or its input over 1 - p, and the kept share of the non-zero
inputs is within six standard deviations of 1 - p."""
from __future__ import annotations

import contextlib
import math

from program import PACKAGE, patched


class Recorder(contextlib.ExitStack):
    def __init__(self):
        super().__init__()
        self.masks = []
        #: (entries kept at a wrong value, the kept share's distance from
        #: 1 - p in standard deviations), one a call
        self.stats = []

    def __enter__(self):
        super().__enter__()
        self.enter_context(patched(f"{PACKAGE}.nn.gcn", "_dropout",
                                   self._wrap))
        return self

    def _wrap(self, orig):
        def _dropout(x, rate, generator):
            out = orig(x, rate, generator)
            if generator is not None and rate:
                keep = out != 0
                self.masks.append(keep.cpu())
                nz = x != 0
                bad = int((keep & (out != x / (1.0 - rate))).sum())
                count = max(int(nz.sum()), 1)
                share = float((keep & nz).sum()) / count
                sd = math.sqrt(rate * (1.0 - rate) / count)
                self.stats.append((bad, (share - (1.0 - rate)) / sd))
            return out
        return _dropout

    def attach(self, steps):
        """Each batch's masks, in call order, as ``b["draws"]["masks"]``;
        the count of calls that break the rule."""
        batches = [b for step in steps for b in step]
        per = len(self.masks) // max(len(batches), 1)
        for k, b in enumerate(batches):
            b.setdefault("draws", {})["masks"] = \
                self.masks[k * per:(k + 1) * per]
        bad = sum(n + int(abs(z) > 6) for n, z in self.stats)
        return bad + int(per * len(batches) != len(self.masks))
