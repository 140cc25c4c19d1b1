"""Device kernels launched per training step: every kernel event of the
profiled stretch over its steps (the host-paced step's count)."""

LAYERS = ()


def read(ctx):
    tr = ctx["trace"]
    return tr["kernel_events"] / tr["units"]
