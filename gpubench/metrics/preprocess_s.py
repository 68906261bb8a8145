"""Seconds of the window's preprocessing: the k-core peel and the walks
(``preprocessing/``), the benchmark's span around the call."""


def read(ctx):
    return ctx["spans"].get("preprocess")
