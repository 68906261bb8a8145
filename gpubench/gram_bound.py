"""The least time of the VAE loss's dense softplus sum over the traced
run: its GEMMs' FLOPs, (2 ``vae.gram_pairs_fwd`` + 4 ``vae.gram_pairs_bwd``)
d, over the peak at the configuration's precision.  The pairs are the
program's counters (N^2 a call each way: z z^T once forward, and again
with its product with z backward); d, the width of z, is the
``embed_dim`` of the configurations of the cells that report
``gram_roofline`` (``BENCHMARK.json``), and the bound is None where they
differ.  The operations bind it: it reads z (N d elements) and writes a
scalar forward, and reads z twice and writes dz backward, 16 N d bytes in
float32 for 6 N^2 d FLOPs, 8 / (3 N) of a byte a FLOP (3.1e-5 at N =
87,036), where the HBM rate over the FP32 peak allows 0.05."""
from __future__ import annotations

import json
import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "gram_roofline"


def _json(*parts):
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


def embed_dim(root=CHECKOUT):
    """The one ``embed_dim`` of the configurations of ``METRIC``'s cells,
    or None."""
    bench = _json(root, "BENCHMARK.json")
    cells = next((m.get("workloads", []) for m in bench["per_layer"]
                  if m["name"] == METRIC), [])
    names = {w["config"] for w in bench["workloads"] if w["name"] in cells}
    dims = {_json(root, c["file"]).get("embed_dim")
            for c in bench["configs"] if c["name"] in names}
    return dims.pop() if len(dims) == 1 else None


def gram_bound_s(counters, d, peak_flops):
    """Seconds, or None where the run formed no pair or d is unknown."""
    flops = (2 * counters.get("vae.gram_pairs_fwd", 0)
             + 4 * counters.get("vae.gram_pairs_bwd", 0)) * (d or 0)
    return flops / peak_flops if flops else None
