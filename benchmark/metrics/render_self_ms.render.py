"""Device ms per view of the renderer's own work around its stages: `render.view`'s
device ms less those of the spans inside it (the intersection, the sampling, the field,
the compositing), so the padding, the tiles' slicing, the final `cat` and the device's
idle time between the stages. None where no view was timed on the device."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    view = [r for (name, _), r in snap.items() if name == "render.view"]
    views = sum(r["device_calls"] for r in view)
    if not views:
        return None
    inside = sum(r["device_ms"] for (_, parent), r in snap.items() if parent == "render.view")
    return (sum(r["device_ms"] for r in view) - inside) / views
