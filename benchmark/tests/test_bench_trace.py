"""The trace's reduction: busy time as the union of device intervals, kernels
by layer from the pattern files, the idle gaps by the host operation open
at their middle."""

import pytest

from harness import trace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_device_summary():
    events = [_x("kernel", "void trunk_fwd_kernel<256>", 0, 10), _x("kernel", "gemm", 5, 10),
              _x("gpu_memcpy", "Memcpy DtoH", 30, 5), _x("kernel", "multi_tensor_apply_kernel", 40, 2),
              _x("cpu_op", "aten::mm", 0, 100)]
    out = trace.device_summary(events, {"field_train": ["trunk_fwd_kernel"],
                                        "optimizer": ["multi_tensor_apply_kernel"],
                                        "intersection": ["intersect_kernel"]})
    assert out["busy_s"] == pytest.approx(22e-6)
    assert out["kernel_events"] == 3
    assert out["layers"]["field_train"] == {"seconds": pytest.approx(10e-6), "events": 1}
    assert out["layers"]["intersection"]["events"] == 0
    assert out["device_ops"][0][0] in ("gemm", "void trunk_fwd_kernel<256>")


def test_idle_gaps_by_host_operation():
    events = [_x("user_annotation", trace.STRETCH, 0, 100),
              _x("cpu_op", "bench.step", 0, 60), _x("cpu_op", "aten::copy_", 20, 30),
              _x("cpu_op", "bench.readback", 60, 40),
              _x("kernel", "k", 0, 20), _x("kernel", "k", 50, 30), _x("kernel", "k", 90, 10)]
    gaps = dict(trace.idle_gaps(events))
    assert gaps == {"aten::copy_": pytest.approx(30e-6), "bench.readback": pytest.approx(10e-6)}


def test_a_silent_layer_fails_after_three_sessions(monkeypatch, tmp_path):
    import contextlib

    import torch.profiler

    calls = []
    monkeypatch.setattr(trace, "_trace_events", lambda prof, d: [])
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext())

    def work():
        calls.append(1)
        return 1

    with pytest.raises(trace.SilentLayer):
        trace.traced_stretch(work, str(tmp_path), {"field_train": ["x"]}, {"field_train"},
                             lambda: None)
    assert len(calls) == trace.ATTEMPTS


def test_the_device_readers_of_a_render_stretch():
    from harness import core

    ctx = {"trace": {"busy_s": 0.18, "window_s": 0.3, "units": 2}}
    assert core.metric_reader("device_idle_pct.render").read(ctx) == pytest.approx(40.0)
    assert core.metric_reader("render_busy_ms.render").read(ctx) == pytest.approx(90.0)
