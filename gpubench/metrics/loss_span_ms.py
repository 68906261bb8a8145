"""Device milliseconds an epoch of work inside the program's ``loss`` spans
(``losses.negative_sampling_loss``, its forward and its backward): the
time between each span's two events, summed over the traced run, less
the device idle inside the spans on the shared clock
(``program_spans.work_ms``)."""
import program_spans


def read(ctx):
    return program_spans.work_ms(ctx, "loss")
