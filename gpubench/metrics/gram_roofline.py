"""Share (%) of the VAE loss's dense softplus sum's least time
(``gram_bound.gram_bound_s``: its GEMMs' FLOPs, from the program's pair
counters and the configuration's width, over the peak at the
configuration's precision) in the device work of the program's ``gram``
spans (``gram_ms``, times the traced epochs)."""
from gram_bound import embed_dim, gram_bound_s
from metrics.mfu import PEAK_KEY

import program_spans


def read(ctx):
    prog, peaks = program_spans.session(ctx), ctx["peaks"]
    if not prog or not peaks:
        return None
    bound = gram_bound_s(prog["counters"], embed_dim(),
                         peaks[PEAK_KEY[ctx["precision"]]])
    ms = program_spans.work_ms(ctx, "gram")
    if bound is None or not ms or ms <= 0:
        return None
    return 100.0 * bound / (ms * program_spans.epochs(prog) / 1e3)
