"""The share of the hybrid field's grid points that kernel G encoded with lane-paired gathers:
the counter `render.grid.points_paired` over `render.grid.points` (each level of each evaluated
tile), over the whole run. None where the program encodes no grid point (a configuration
without a grid) or does not count paired points (a program without the pairing)."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    if not hasattr(profiling, "snapshot"):
        return None
    snap = profiling.snapshot()
    points = sum(r["calls"] for (name, _), r in snap.items() if name == "render.grid.points")
    paired = [r["calls"] for (name, _), r in snap.items() if name == "render.grid.points_paired"]
    if points == 0 or not paired:
        return None
    return 100.0 * sum(paired) / points
