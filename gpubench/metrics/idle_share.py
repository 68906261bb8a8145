"""Share (%) of the traced window in which no device operation ran: 1 -
the union of the operations' intervals over the window's wall time."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
