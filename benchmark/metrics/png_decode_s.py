"""Seconds of decoding inside make_dataset (span `data.decode` under `data.make_dataset`:
`viz/png.py: read_png` and the `.npy` streams' loads), host clock. None where the run
recorded no such span."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()
SPAN = "data.decode"


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    rows = [r for (name, parent), r in snap.items() if name == SPAN and parent == "data.make_dataset"]
    return sum(r["host_s"] for r in rows) if rows else None
