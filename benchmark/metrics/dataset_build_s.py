"""Seconds of the scene's making: writing a tree (where the configuration
has one) and the program's `make_dataset`, host clock, synchronised."""

LAYERS = ()


def read(ctx):
    return ctx["dataset_build_s"]
