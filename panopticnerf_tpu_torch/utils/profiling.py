"""Tracing and timing helpers (port of `panopticnerf_tpu/utils/profiling.py`).

`trace(log_dir)` records a `torch.profiler` trace of a region (the CPU,
and the card's kernels when CUDA is available) and writes it as a Chrome
trace (chrome://tracing, Perfetto); `timed` times a callable in seconds
per call, synchronising the card around the timed calls; `enable_debug_nans`
makes autograd raise where a backward produces NaN.

`span(name)` and `count(name, n)` measure the program from inside, into an
in-memory table keyed by (name, parent), the parent being the span open
around it on the same thread. A span always adds its call and its host
seconds, to its own thread's rows and without a lock. While a `torch.profiler` session is active (any session: `trace()`
or a device-only one) it also opens a `record_function` range, so it shows
in the Chrome trace on the device's timeline, and records a pair of CUDA
events on the current stream: the span's device time, its stream's wall
from the start marker to the end marker, resolved when the table is read.
A counter adds `n` to its row's calls. `snapshot()` reads the table,
`calls(name)` one name's calls over every parent, `reset()` clears it.
Rows are aggregates, never per-call records, so the table stays small.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler


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


# ------------------------------------------------------- spans and counters
# Each thread keeps its own stack of open spans and its own table,
# (name, parent) -> [calls, host seconds], which only it writes: a span that
# is off takes no lock. `snapshot()` sums the threads' tables. Device times
# go to one shared table under `_lock`, (name, parent) -> [calls, ms].
_tables: list = []  # every thread's table, dead threads' included
_device: dict = {}
# (key, start event, end event) of device-timed spans not yet read
_pending: list = []
_events: list = []  # finished CUDA events, for reuse
_streams: dict = {}  # (device, raw stream) -> torch.cuda.Stream
_lock = threading.Lock()
_RESOLVE_AT = 1024  # every this many pending pairs, the finished ones are read


class _Thread(threading.local):
    def __init__(self):
        self.stack = []
        self.table = {}
        with _lock:
            _tables.append(self.table)


_local = _Thread()


def _device_mark():
    """A timing event recorded on the current stream, or None where no
    CUDA work can be under way (CUDA never initialised in this process).
    The stream object is cached by its handle: building it is most of an
    uncached record's host time."""
    if not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(dev)
    try:
        ev = _events.pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _resolve(block: bool) -> None:
    """Add the device ms of pending span pairs to their rows: all of them
    (waiting for the device) with `block`, else those the device has
    reached, in the order they were recorded."""
    with _lock:
        todo = _pending[:]
        _pending.clear()
    done = 0
    for _, a, b in todo:
        if block:
            a.synchronize()
            b.synchronize()
        elif not (a.query() and b.query()):
            break
        done += 1
    times = [a.elapsed_time(b) for _, a, b in todo[:done]]
    with _lock:
        _pending[:0] = todo[done:]
        for (key, a, b), ms in zip(todo, times):
            row = _device.setdefault(key, [0, 0.0])
            row[0] += 1
            row[1] += ms
            _events.extend((a, b))


class span(contextlib.ContextDecorator):
    """Measure a region (`with span("render.view"):`) or every call of a
    function (`@span("data.decode")`). With `sync`, the card is synchronised
    before the end is read, so host seconds hold the region's device work."""

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync

    def __enter__(self):
        st = _local.stack
        parent = st[-1][0] if st else None
        rf = ev = None
        if _autograd_profiler._is_profiler_enabled:
            rf = _autograd_profiler.record_function(self.name)
            rf.__enter__()
            ev = _device_mark()
        st.append((self.name, parent, rf, ev, time.perf_counter()))
        return self

    def __exit__(self, *exc):
        name, parent, rf, ev, t0 = _local.stack.pop()
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        host = time.perf_counter() - t0
        key = (name, parent)
        table = _local.table
        row = table.get(key)
        if row is None:
            row = table[key] = [0, 0.0]
        row[0] += 1
        row[1] += host
        if ev is not None:
            end = _device_mark()
            rf.__exit__(None, None, None)
            with _lock:
                _pending.append((key, ev, end))
                resolve = len(_pending) % _RESOLVE_AT == 0
            if resolve:
                _resolve(block=False)
        elif rf is not None:
            rf.__exit__(None, None, None)
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` under the span open around it."""
    st = _local.stack
    key = (name, st[-1][0] if st else None)
    table = _local.table
    row = table.get(key)
    if row is None:
        row = table[key] = [0, 0.0]
    row[0] += int(n)


def _merged() -> dict:
    """(name, parent) -> [calls, host s, device-timed calls, device ms],
    summed over the threads' tables."""
    out: dict = {}
    with _lock:
        tables = [t.copy() for t in _tables]
        device = {k: list(r) for k, r in _device.items()}
    for t in tables:
        for key, (n, host) in t.items():
            row = out.setdefault(key, [0, 0.0, 0, 0.0])
            row[0] += n
            row[1] += host
    for key, (n, ms) in device.items():
        row = out.setdefault(key, [0, 0.0, 0, 0.0])
        row[2] += n
        row[3] += ms
    return out


def snapshot() -> dict:
    """(name, parent) -> {"calls", "host_s", "device_calls", "device_ms"}
    (a counter's total is its calls); waits for the device to reach every
    device-timed span first."""
    _resolve(block=True)
    return {k: {"calls": r[0], "host_s": r[1], "device_calls": r[2], "device_ms": r[3]}
            for k, r in _merged().items()}


def calls(name: str) -> int:
    """Calls of a span, or a counter's total, summed over every parent."""
    return sum(r[0] for (n, _), r in _merged().items() if n == name)


def reset() -> None:
    """Clear the table (spans open now still add their row when they close)."""
    with _lock:
        for t in _tables:
            t.clear()
        _device.clear()
        _pending.clear()
