"""The traced stretch: a few units of the cell's work (steps or views) under
`torch.profiler`, read from its Chrome trace.

From a stretch traced on the device alone: its wall length (host clock,
synchronised at both ends), the device's busy seconds (the union of every
kernel, copy and fill), each kernel layer's device seconds and event count
(a kernel belongs to the layer of `kernel_names/<layer>/` whose pattern
its name contains), and the device operations that took most time. From a
second stretch traced on the host as well: the idle gaps by what the host
was doing (the innermost host operation open at each gap's middle).

CUPTI now and then hands the profiler no kernel records of a session, so a
stretch in which a layer that the cell's metrics read shows no event is
profiled again, up to three sessions; a layer still silent then fails the
run rather than read 0.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time
import warnings
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
ATTEMPTS = 3
STRETCH = "bench.stretch"


class SilentLayer(RuntimeError):
    pass


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_events(events: list, lo: float = -float("inf"), hi: float = float("inf")):
    """(device intervals clipped to [lo, hi], kernels as (name, us)) of a trace."""
    dev, kernels = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b <= lo or a >= hi:
            continue
        dev.append((max(a, lo), min(b, hi)))
        if e["cat"] == "kernel":
            kernels.append((e["name"], b - a))
    return dev, kernels


def device_summary(events: list, patterns: dict) -> dict:
    """From a device-only trace of the stretch: the busy seconds, the
    kernel count, each layer's kernel seconds and events, the device
    operations that took most time."""
    dev, kernels = _device_events(events)
    busy_us = sum(b - a for a, b in _union(dev))
    layers = {layer: {"seconds": 0.0, "events": 0} for layer in patterns}
    by_name = defaultdict(float)
    for name, dur in kernels:
        by_name[name] += dur
        for layer, pats in patterns.items():
            if any(p in name for p in pats):
                layers[layer]["seconds"] += dur * 1e-6
                layers[layer]["events"] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "kernel_events": len(kernels), "layers": layers,
            "device_ops": [[n[:160], s * 1e-6] for n, s in ops]}


def idle_gaps(events: list) -> list:
    """From a host-and-device trace: the idle gaps of the device inside the
    `bench.stretch` span, summed by the innermost host operation open at
    each gap's middle; the ten largest as [name, seconds]."""
    span = [e for e in events if e.get("name") == STRETCH and e.get("cat") in HOST_CATS
            and e.get("ph") == "X"]
    if not span:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    busy = _union(_device_events(events, w0, w1)[0])
    tid = span[0].get("tid")
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("tid") == tid and e["name"] != STRETCH)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host, outside any operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += b - a
    return [[n[:160], s * 1e-6] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]


def _trace_events(prof, tmpdir: str) -> list:
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events


def traced_stretch(work, tmpdir: str, patterns: dict, required: set, sync) -> dict:
    """Two profiled stretches of `work()` (it does the stretch's units,
    synchronises, and returns how many units it did). The first traces the
    device alone, which costs the host little: the busy seconds, the
    kernels and the layers, over the stretch's host-clock seconds (both
    ends synchronised). The second adds the host's operations, which slow
    a host-paced loop, and gives only the idle gaps by host operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    warnings.filterwarnings("ignore", message=".*Profiler clears events at the end of each cycle")
    for attempt in range(1, ATTEMPTS + 1):
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            units = work()
            window_s = time.perf_counter() - t0
        out = device_summary(_trace_events(prof, tmpdir), patterns)
        silent = sorted(layer for layer in required if out["layers"][layer]["events"] == 0)
        if not silent:
            break
        print(f"the profiler saw no kernel of {silent} (session {attempt} of {ATTEMPTS})",
              file=sys.stderr, flush=True)
    else:
        raise SilentLayer(f"no kernel of {silent} in {ATTEMPTS} profiled sessions")
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        with record_function(STRETCH):
            work()
        host_traced_s = time.perf_counter() - t1
    out.update(units=units, window_s=window_s, attempts=attempt, host_traced_s=host_traced_s,
               idle_gaps=idle_gaps(_trace_events(prof, tmpdir)))
    return out
