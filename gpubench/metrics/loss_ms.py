"""Device milliseconds an epoch inside the loss: its forward and its
backward, each bracketed by the benchmark's markers."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["ranges"] or not tr["ranges"].get("loss"):
        return None
    return tr["ranges"]["loss"] / 1e3 / tr["epochs"]
