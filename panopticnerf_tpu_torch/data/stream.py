"""Streaming windows of views from a host-resident pool (port of
`panopticnerf_tpu/data/stream.py`).

A run whose views do not fit on the device beside the model keeps the whole
pool in host memory (`make_dataset` with data.stream_window W > 0) and
trains on a window of W views resident on the device, redrawn every
data.stream_refresh_steps. The step itself is unchanged: it receives a
`DeviceDataset` of the same shapes.

`ViewWindowStreamer` draws windows as the reference does and uploads the
next one while the current one trains: a background thread gathers the
window into pinned staging buffers and copies them to the device on a side
CUDA stream; `advance()` makes the consuming stream wait for that copy (an
event, not a host synchronisation) and marks the window's tensors as used
by it (`record_stream`), so that the caching allocator does not hand a
retired window's memory to the next upload while a step still reads it.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from panopticnerf_tpu_torch.data.dataset import DeviceDataset

# Fields with a leading view axis; the others (the scene bounds) go whole.
PER_VIEW = frozenset(DeviceDataset._fields) - {"bounds_center", "bounds_scale"}


def views_to(ds: DeviceDataset, view_ids, device: torch.device | str,
             non_blocking: bool = False) -> DeviceDataset:
    """The views `view_ids` of the host-resident `ds` (renumbered 0..) on
    `device`, every other field whole. With `non_blocking` (a CUDA device)
    each field is gathered into pinned memory and copied asynchronously on
    the current stream: a slice of a tensor is pageable memory, from which
    a copy is synchronous."""
    device = torch.device(device)
    pin = non_blocking and device.type == "cuda"
    idx = torch.as_tensor(np.asarray(view_ids), dtype=torch.long)
    out = {}
    for name, v in ds._asdict().items():
        if v is None:
            out[name] = None
            continue
        if name in PER_VIEW:
            host = torch.empty((len(idx),) + tuple(v.shape[1:]), dtype=v.dtype, pin_memory=pin)
            torch.index_select(v, 0, idx, out=host)
        else:
            host = v.pin_memory() if pin else v
        out[name] = host.to(device, non_blocking=pin)
    return DeviceDataset(**out)


def draw_window(rng: np.random.Generator, pool: np.ndarray, size: int) -> np.ndarray:
    """The reference's window draw: min(size, len(pool)) distinct views of
    `pool`, sorted."""
    return np.sort(rng.choice(pool, min(size, len(pool)), replace=False))


class HostViews:
    """The view pool in host memory (a `DeviceDataset` of CPU tensors) and
    the device its windows go to. The pool stays pageable: every window is a
    gather, which `views_to` writes into pinned staging memory."""

    def __init__(self, ds: DeviceDataset, device: torch.device | str):
        self.ds = DeviceDataset(*[None if t is None else t.cpu() for t in ds])
        self.device = torch.device(device)
        self.num_views = self.ds.images.shape[0]

    def window(self, view_ids) -> DeviceDataset:
        """The views `view_ids` on the device (a synchronous upload)."""
        return views_to(self.ds, view_ids, self.device)


class ViewWindowStreamer:
    """Double-buffered window rotation with the reference's draws.

    The pool is `include` (default: every view). Windows are drawn by
    `np.random.default_rng(seed)` as `sort(choice(pool, W, replace=False))`
    with W = min(window_size, len(pool)): the first at construction
    (uploaded synchronously), then the next one, which a background thread
    uploads. `advance()` swaps it in and draws the one after. With `skip`
    the first `skip` windows are drawn and dropped without an upload, so a
    resumed run continues the window sequence of an uninterrupted one.

    `current()` / `advance()` -> (window `DeviceDataset`, its pool view ids).
    `blocked` holds the host seconds each `advance()` waited for the upload
    thread, `ready` whether the copy had already finished on the device at
    that moment (always True off CUDA). An upload that failed makes
    `advance()` raise.
    """

    def __init__(self, host: HostViews, window_size: int, seed: int = 0,
                 include: Optional[np.ndarray] = None, skip: int = 0):
        self.host = host
        self.pool = np.asarray(include) if include is not None else np.arange(host.num_views)
        self.window_size = min(window_size, len(self.pool))
        self.rng = np.random.default_rng(seed)
        for _ in range(skip):
            self._draw()
        self.refreshes = skip  # windows swapped in, counting the skipped ones
        self.blocked: list[float] = []
        self.ready: list[bool] = []
        cuda = host.device.type == "cuda"
        self._stream = torch.cuda.Stream(host.device) if cuda else None
        self._thread: Optional[threading.Thread] = None
        self._next = None
        self._error: Optional[BaseException] = None
        ids = self._draw()
        self._current = (host.window(ids), ids)
        self._start_prefetch()

    def _draw(self) -> np.ndarray:
        return draw_window(self.rng, self.pool, self.window_size)

    def _upload(self, ids: np.ndarray):
        """-> (window, ids, event | None), run by the prefetch thread."""
        if self._stream is None:
            return self.host.window(ids), ids, None
        with torch.cuda.device(self.host.device), torch.cuda.stream(self._stream):
            ds = views_to(self.host.ds, ids, self.host.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return ds, ids, event

    def _start_prefetch(self) -> None:
        ids = self._draw()
        self._next, self._error = None, None

        def work():
            try:
                self._next = self._upload(ids)
            except Exception as e:  # re-raised by advance()
                self._error = e

        self._thread = threading.Thread(target=work, name="view-window-upload", daemon=True)
        self._thread.start()

    def current(self) -> tuple[DeviceDataset, np.ndarray]:
        return self._current

    def advance(self) -> tuple[DeviceDataset, np.ndarray]:
        """Swap in the uploaded window (blocking only while its thread still
        runs) and start the upload of the next."""
        t0 = time.perf_counter()
        self._thread.join()
        self.blocked.append(time.perf_counter() - t0)
        if self._error is not None:
            raise RuntimeError("the upload of the next view window failed") from self._error
        ds, ids, event = self._next
        if event is not None:
            main = torch.cuda.current_stream(self.host.device)
            self.ready.append(event.query())
            main.wait_event(event)
            for t in ds:
                if t is not None:
                    t.record_stream(main)
        else:
            self.ready.append(True)
        self._current = (ds, ids)
        self.refreshes += 1
        self._start_prefetch()
        return self._current

    def close(self) -> None:
        """Wait for the upload thread; the streamer is done with."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
