"""Tracing and timing helpers (port of `panopticnerf_tpu/utils/profiling.py`).

`trace(log_dir)` records a `torch.profiler` trace of a region (the CPU,
and the card's kernels when CUDA is available) and writes it as a Chrome
trace (chrome://tracing, Perfetto); `timed` times a callable in seconds
per call, synchronising the card around the timed calls; `enable_debug_nans`
makes autograd raise where a backward produces NaN.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region; on exit write `<log_dir>/trace.json` (Chrome
    trace format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Seconds per call of `fn(*args, **kw)`: `warmup` calls, then `iters`
    timed calls between two synchronisations of the card."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _sync()
    return (time.perf_counter() - t0) / iters


def enable_debug_nans(on: bool = True) -> None:
    """Autograd's anomaly mode: a backward that produces NaN raises, with
    the forward op's traceback."""
    torch.autograd.set_detect_anomaly(on)
