"""Device busy milliseconds per rendered view in the traced stretch: the union
of every device operation's time over the views traced. The host's pace does
not enter it, so it moves with the device's work alone where the render's
rate follows the host."""

LAYERS = ()


def read(ctx):
    tr = ctx["trace"]
    return 1000.0 * tr["busy_s"] / tr["units"]
