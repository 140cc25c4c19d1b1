"""The control at a small size: the reference with float8 operands, put in
the program's place, fails a limit that the program's own run keeps (the
card's readings at the cells' sizes are in PERF.md)."""

import contextlib
import io
import json
import os

import pytest
import torch

import readings
from conftest import BENCH_DIR, SMALL


@pytest.mark.parametrize("workload", ["kitti360-train", "kitti360-render", "flagship-render"])
def test_the_control_fails_and_the_program_passes(workload):
    torch.set_num_threads(2)
    limits = json.load(open(os.path.join(BENCH_DIR, "limits", f"{workload}.json")))
    spec_cells = {"kitti360-train"}
    with contextlib.redirect_stdout(io.StringIO()):
        if workload in spec_cells:
            from test_bench_run import spec_with_training

            rec = readings.main(["--workload", workload, "--seeds", "2"], device="cpu",
                                overrides=SMALL, spec=spec_with_training())[0]
        else:
            rec = readings.main(["--workload", workload, "--seeds", "2"], device="cpu",
                                overrides=SMALL)[0]
    assert all(rec["program"][k] <= v for k, v in limits.items())
    assert any(rec["control"][k] > v for k, v in limits.items())
    assert any(rec["half_batch"][k] > v for k, v in limits.items())
