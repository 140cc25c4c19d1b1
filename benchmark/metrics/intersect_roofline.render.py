"""Kernel A1 against its roofline: the least time of each profiled view's
intersection (its own bytes at HBM's rate, or its slab and cut-plane tests
at the f32 peak, whichever is larger), over A1's device time there."""

from harness import yardstick as ys

LAYERS = ("intersection",)


def read(ctx):
    least = sum(ys.intersect_least_ms(1, s["n"], s["p"], s["p_valid"], s["f"], s["k"])[0]
                for s in ctx["a1_shapes"])
    return 100.0 * least * 1e-3 / ctx["trace"]["layers"]["intersection"]["seconds"]
