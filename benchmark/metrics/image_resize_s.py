"""Seconds of resizing inside make_dataset (span `data.resize` under `data.make_dataset`:
`data/image.py: resize_bilinear` and `resize_nearest`), host clock. None where the run
recorded no such span."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()
SPAN = "data.resize"


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    rows = [r for (name, parent), r in snap.items() if name == SPAN and parent == "data.make_dataset"]
    return sum(r["host_s"] for r in rows) if rows else None
