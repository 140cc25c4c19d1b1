"""Whole runs on the CPU at a small size, with the harness's look for a card
skipped: the last line's form, the comparison coming out false under each
fault a cell can have, a run without a card, and a run from a tree that
holds only the benchmark."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import run
from conftest import BENCH_DIR, SMALL

ROOT = os.path.dirname(BENCH_DIR)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def spec_with_training():
    """BENCHMARK.json with the training cell that the harness keeps ready
    (see PERF.md, Open questions) and its end-to-end metric."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["workloads"].append({"name": "kitti360-train", "config": "kitti360_panoptic",
                              "traffic": "train", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "train_rays_per_s", "unit": "rays/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["kitti360-train"]})
    return spec


def one_run(workload, fault=None):
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", workload, "--seed", "3000000001", "--seconds", "1",
                       "--trace", "0"], device="cpu", fault=fault, overrides=SMALL,
                      spec=spec_with_training())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload,fault", [
    ("kitti360-train", None), ("kitti360-train", "state_unchanged"),
    ("kitti360-train", "half_batch"),
    ("kitti360-render", None), ("kitti360-render", "half_batch"),
    ("kitti360-render", "alter_answer"),
    ("flagship-render", None), ("flagship-render", "half_batch"),
    ("flagship-render", "alter_answer")])
def test_a_fault_comes_out_incorrect(workload, fault):
    line = one_run(workload, fault)
    assert list(line) == KEYS
    assert line["correct"] is (fault is None)
    assert line["failed"] == 0 and line["attempted"] > 0
    rate = "train_rays_per_s" if workload.endswith("train") else "render_rays_per_s"
    assert set(line["metrics"]) == {rate, "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_a_run_without_a_card_fails():
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                          "flagship-render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_tree_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "sys.exit(run.main(['--workload', 'flagship-render', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "panopticnerf_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                          "flagship-render", "--seed", "7", "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < line["metrics"]["intersect_roofline.render"]["value"] <= 100
