"""Device ms per view of the hybrid field's hash grid encoding (kernel G): the
spans `render.grid.coarse` and `render.grid.fine` inside `render.field.<level>`
(the program's own CUDA events), their device ms over the profiled stretches'
views (the device-timed calls of `render.view`). None where no view was timed
on the device or the program has no such span."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()
SPANS = {("render.grid.coarse", "render.field.coarse"), ("render.grid.fine", "render.field.fine")}


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    views = sum(r["device_calls"] for (name, _), r in snap.items() if name == "render.view")
    grid = [r["device_ms"] for key, r in snap.items() if key in SPANS]
    if not views or not grid:
        return None
    return sum(grid) / views
