"""Share (%) of the core-axis RNN's slot steps that step a valid core slot
over the traced run: the program's counters ``core_rnn.valid_slot_steps``
over ``core_rnn.slot_steps``, both counted on the host."""
import program_spans


def read(ctx):
    prog = program_spans.session(ctx)
    if not prog:
        return None
    steps = prog["counters"].get("core_rnn.slot_steps", 0)
    if not steps:
        return None
    return 100.0 * prog["counters"].get("core_rnn.valid_slot_steps",
                                        0) / steps
