"""Seconds of building and loading the CUDA kernel libraries in the run (span
`kernels.load`, `ops/_nvcc.py: load`: nvcc where `panopticnerf_tpu_torch/_build/` lacks
the library, counter `kernels.built`, then its load), host clock. None where the run
recorded no such span."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {}
    rows = [r for (name, parent), r in snap.items()
            if name == "kernels.load" and parent != "kernels.load"]
    return sum(r["host_s"] for r in rows) if rows else None
