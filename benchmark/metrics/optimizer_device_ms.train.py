"""Device time of the optimizer's kernels (the foreach Adam update) per
training step, in the profiled stretch."""

LAYERS = ("optimizer",)


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * tr["layers"]["optimizer"]["seconds"] / tr["units"]
