"""Seconds of ``build_trainer`` for window 0: loaders, plans, schedules,
splits and the model (the benchmark's span around the call)."""


def read(ctx):
    return ctx["spans"].get("window_setup")
