"""The share of the profiled training stretch's wall time in which nothing
ran on the device."""

LAYERS = ()


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
