"""Device ms per panorama of the panorama's ray making: the span `render.panorama.rays`
inside `render.panorama` (`render/panorama.py`, the program's own CUDA events), its device
ms over the device-timed calls of `render.panorama`. None where no panorama was timed on
the device or the program has no such span."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    panoramas = sum(r["device_calls"] for (name, _), r in snap.items()
                    if name == "render.panorama")
    rays = [r["device_ms"] for key, r in snap.items()
            if key == ("render.panorama.rays", "render.panorama")]
    if not panoramas or not rays:
        return None
    return sum(rays) / panoramas
