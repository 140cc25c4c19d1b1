"""The port's profiling helpers (panopticnerf_tpu_torch/utils/profiling.py)
on the CPU: the port of tests/test_multiseq_profiling.py::test_timed_helper,
a Chrome trace written by `trace()`, anomaly mode switched by
`enable_debug_nans`, and the spans and counters: their table, their ranges
in the profiler's trace, and the renderer's and the loader's spans (the
device times are tested on the card, tests/test_torch_cuda.py)."""

import json
import os
import sys
import threading
import time
import warnings

import pytest
import torch

from panopticnerf_tpu_torch.utils import (
    count,
    enable_debug_nans,
    profiling,
    snapshot,
    span,
    timed,
    trace,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_timed_helper():
    dt = timed(lambda x: x * 2, torch.ones(16), iters=3)
    assert dt > 0


def test_timed_runs_warmup_and_iters():
    calls = []
    timed(calls.append, 1, iters=4, warmup=2)
    assert len(calls) == 6


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "tr")):
        y = torch.relu(x @ x)
    assert float(y.sum()) >= 0
    path = tmp_path / "tr" / "trace.json"
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names and "aten::relu" in names


def test_enable_debug_nans():
    try:
        enable_debug_nans(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # anomaly mode's own traceback warning
            torch.sqrt(x).sum().backward()
    finally:
        enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()


# ------------------------------------------------------- spans and counters


@pytest.fixture
def table():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_profiler_flag_spans_read():
    """A span opens its record_function and device events only while
    torch's fast flag says a profiler session is active: pin the flag."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_span_without_a_profiler_records_host_time_only(table, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("opened outside a profiler session")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with span("outer"):
        with span("inner"):
            time.sleep(0.01)
        with span("inner"):
            count("things", 3)
    snap = snapshot()
    assert set(snap) == {("outer", None), ("inner", "outer"), ("things", "inner")}
    assert snap[("inner", "outer")]["calls"] == 2 and snap[("things", "inner")]["calls"] == 3
    assert snap[("outer", None)]["host_s"] >= snap[("inner", "outer")]["host_s"] >= 0.01
    assert all(r["device_calls"] == 0 and r["device_ms"] == 0.0 for r in snap.values())
    assert not torch.cuda.is_initialized()


def test_a_span_that_is_off_takes_no_lock(table, monkeypatch):
    """With no profiler session a span and a counter write only their own
    thread's rows: the shared lock is never taken on that path."""
    class Refuse:
        def __enter__(self):
            raise AssertionError("the lock was taken with the spans off")

        def __exit__(self, *exc):
            return False

    with span("warm"):  # this thread's table, registered under the lock
        pass
    monkeypatch.setattr(profiling, "_lock", Refuse())
    for _ in range(3):
        with span("outer"):
            count("things", 2)
    monkeypatch.undo()
    snap = snapshot()
    assert snap[("outer", None)]["calls"] == 3 and snap[("things", "outer")]["calls"] == 6


def test_spans_nest_in_the_chrome_trace(table, tmp_path):
    x = torch.randn(32, 32)
    with trace(str(tmp_path / "tr")):
        with span("outer"):
            with span("inner"):
                x = x @ x
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("name") in ("outer", "inner")}
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert set(snapshot()) == {("outer", None), ("inner", "outer")}


def test_span_decorates_a_function_and_calls_sum_over_parents(table):
    @span("leaf")
    def leaf(v):
        return v + 1

    assert leaf(1) == 2 and leaf.__name__ == "leaf"
    with span("a"):
        leaf(0)
        with span("b"):
            leaf(0)
    assert profiling.calls("leaf") == 3
    assert {k: r["calls"] for k, r in snapshot().items() if k[0] == "leaf"} == {
        ("leaf", None): 1, ("leaf", "a"): 1, ("leaf", "b"): 1}
    profiling.reset()
    assert snapshot() == {} and profiling.calls("leaf") == 0


def test_counters_and_spans_from_many_threads(table):
    """Each thread has its own stack of open spans; no update to the shared
    table is lost."""
    n_threads, n = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with span(f"t{i}"):
                for _ in range(n):
                    count("c")
                    with span("s"):
                        pass

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = snapshot()
    assert profiling.calls("c") == profiling.calls("s") == n_threads * n
    assert all(snap[("c", f"t{i}")]["calls"] == n and snap[("s", f"t{i}")]["calls"] == n
               for i in range(n_threads))


def _flagship_small_field():
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import make_network

    cfg = load_config(os.path.join(REPO, "configs", "synthetic_flagship.yaml"), [
        "data.synthetic_num_frames", "2", "model.trunk_depth", "2", "model.trunk_width", "16",
        "model.skips", "0", "model.color_width", "8", "render.n_samples", "8",
        "render.n_importance", "8"])
    ds, _, _ = make_dataset(cfg, "cpu")
    torch.manual_seed(0)
    return cfg, ds, make_network(cfg, "cpu").eval()


def test_render_spans_change_nothing_and_count_tiles(table, one_thread):
    """The flagship's 94x352 view in tiles of 4096 rays (narrow fields):
    the same maps bit for bit with and without a profiler session, each
    stage once per tile and level, and the padding counted."""
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.render.renderer import SceneBounds, intersect_and_render

    cfg, ds, model = _flagship_small_field()
    o, d = view_rays(ds, 1)
    n, tile = o.shape[0], cfg.render.ray_tile
    assert (n, tile) == (94 * 352, 4096)
    render = lambda: intersect_and_render(cfg, model, o, d, view_primitives(ds, 1),
                                          SceneBounds(ds.bounds_center, ds.bounds_scale))
    profiling.reset()
    plain = render()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = render()
    for name, a in plain._asdict().items():
        b = getattr(traced, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    tiles = -(-n // tile)
    snap = snapshot()
    stages = [f"render.{s}.{lv}" for s in ("sample", "field", "composite")
              for lv in ("coarse", "fine")]
    assert {k: r["calls"] for k, r in snap.items() if k[1] == "render.view"} == {
        **{(s, "render.view"): 2 * tiles for s in stages},
        ("render.intersect", "render.view"): 2,
        ("render.rays", "render.view"): 2 * n,
        ("render.rays_padded", "render.view"): 2 * (tiles * tile - n)}
    assert snap[("render.view", None)]["calls"] == 2
    assert all(r["device_calls"] == 0 for r in snap.values())  # no card here


def test_make_dataset_records_its_stages(table, tmp_path):
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree

    root = str(tmp_path / "tree")
    write_demo_tree(root, n_frames=2, hw=(48, 64), n_boxes=3, seed=0, device="cpu")
    cfg = load_config(None, ["data.dataset", "kitti360", "data.root", root,
                             "data.frame_num", "2", "data.ratio", "0.5",
                             "data.max_primitives", "16"])
    profiling.reset()
    make_dataset(cfg, "cpu")
    snap = snapshot()
    assert snap[("data.make_dataset", None)]["calls"] == 1
    inside = {k[0] for k in snap if k[1] == "data.make_dataset"}
    assert {"data.decode", "data.resize", "data.boxes", "data.upload"} <= inside
    top = snap[("data.make_dataset", None)]["host_s"]
    assert sum(r["host_s"] for k, r in snap.items() if k[1] == "data.make_dataset") <= top
