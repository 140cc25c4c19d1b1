"""The port's profiling helpers (panopticnerf_tpu_torch/utils/profiling.py)
on the CPU: the port of tests/test_multiseq_profiling.py::test_timed_helper,
a Chrome trace written by `trace()`, and anomaly mode switched by
`enable_debug_nans`."""

import json
import os
import warnings

import pytest
import torch

from panopticnerf_tpu_torch.utils import enable_debug_nans, timed, trace


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
