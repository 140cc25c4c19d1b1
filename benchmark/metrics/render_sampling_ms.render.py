"""Device ms per view of the renderer's sampling: the guided coarse depths, the inverse-CDF
fine depths and their merge (spans `render.sample.coarse` and `render.sample.fine`
inside `render.view`, the program's own CUDA events): their device ms over the profiled
stretches' views, the device-timed calls of `render.view`. None where no view was timed
on the device."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()
SPANS = ("render.sample.coarse", "render.sample.fine")


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    views = sum(r["device_calls"] for (name, _), r in snap.items() if name == "render.view")
    if not views:
        return None
    return sum(r["device_ms"] for (name, parent), r in snap.items()
               if name in SPANS and parent == "render.view") / views
