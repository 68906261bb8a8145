"""Device milliseconds an epoch of work inside the program's ``gram``
spans (``losses._SoftplusGramSum``, the VAE loss's dense softplus sum over
all N^2 pairs, its forward and its backward): the time between each span's
two events over the traced run, less the device idle inside the spans on
the shared clock (``program_spans.work_ms``)."""
import program_spans


def read(ctx):
    return program_spans.work_ms(ctx, "gram")
