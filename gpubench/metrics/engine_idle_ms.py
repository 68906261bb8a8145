"""Device idle milliseconds an epoch inside the engine's spans
(``batch_plan``, ``batch_inputs``, ``optimizer``, ``readback``): idle
whose innermost span, by the spans' device intervals on the trace's clock
(``program_spans.clock``), is one of them; the wait for the window's
first device op is left out."""
import program_spans


def read(ctx):
    prog, found = program_spans.session(ctx), program_spans.clock(ctx)
    if not prog or found is None or not program_spans.epochs(prog):
        return None
    if not any(s[0] in program_spans.ENGINE for s in prog["spans"]):
        return None                  # a loop without the engine's spans
    us = sum(found["idle_us"].get(name, 0.0)
             for name in program_spans.ENGINE)
    return us / 1e3 / program_spans.epochs(prog)
