"""Seconds of the program's make_dataset (span `data.make_dataset`, host clock, the card
synchronised at its end): the loader alone, without the harness's writing of the scene.
None where the run recorded no such span."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()
SPAN = "data.make_dataset"


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    rows = [r for (name, parent), r in snap.items() if name == SPAN]
    return sum(r["host_s"] for r in rows) if rows else None
