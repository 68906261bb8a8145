"""Device milliseconds an epoch of work inside the program's ``core_rnn``
spans (``ops.rnn``'s core-axis RNN, forward and backward): the time
between each span's two events over the traced run, less the device idle
inside the spans on the shared clock (``program_spans.work_ms``)."""
import program_spans


def read(ctx):
    return program_spans.work_ms(ctx, "core_rnn")
