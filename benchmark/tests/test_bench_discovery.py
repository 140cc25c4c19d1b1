"""The harness finds a configuration, a traffic mix, a per-layer metric and
a kernel-name list by name: each is added as a new file, and no file the
benchmark already has is edited."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR

PROBE = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
from harness import core
bench = core.load_json(sys.argv[2])
cell, conf, conf_file = core.find_cell(bench, "probe-cell")
print(json.dumps({
    "config": conf_file["name"], "traffic": core.load_traffic(cell["traffic"])["kind"],
    "metrics": [m["name"] for m in core.cell_metrics(bench, "probe-cell", "per_layer")],
    "read": core.metric_reader("probe_metric.train").read({"x": 3}),
    "layers": core.kernel_patterns()["probe_layer"]}))
"""


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(os.path.join(d, p), "rb").read() for d, _, fs in os.walk(bench) for p in fs}
    conf = json.load(open(bench / "configs" / "synthetic_flagship.json"))
    conf["name"] = "probe_config"
    (bench / "configs" / "probe_config.json").write_text(json.dumps(conf))
    (bench / "traffic" / "probe_mix.json").write_text(json.dumps(
        {"kind": "train", "why": "probe", "start": "semantic_on", "warmup_steps": 4,
         "check_steps": 1, "trace_steps": 2}))
    (bench / "metrics" / "probe_metric.train.py").write_text(
        "LAYERS = ('probe_layer',)\n\ndef read(ctx):\n    return 2 * ctx['x']\n")
    (bench / "kernel_names" / "probe_layer").mkdir()
    (bench / "kernel_names" / "probe_layer" / "probe.txt").write_text("# probe\nprobe_kernel\n")
    spec = json.load(open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")))
    spec["configs"].append({"name": "probe_config", "source": "probe",
                            "file": "benchmark/configs/probe_config.json", "reduced": [],
                            "why": "probe"})
    spec["workloads"].append({"name": "probe-cell", "config": "probe_config",
                              "traffic": "probe_mix", "chips": 1, "why": "probe"})
    spec["end_to_end"].append({"name": "probe_rate", "unit": "1/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["probe-cell"]})
    spec["per_layer"].append({"name": "probe_metric.train", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "probe", "moves": "probe_rate",
                              "workloads": ["probe-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", PROBE, str(bench), str(tmp_path / "BENCHMARK.json")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "probe_config", "traffic": "train",
                   "metrics": ["probe_metric.train"], "read": 6, "layers": ["probe_kernel"]}
    after = {p: open(os.path.join(d, p), "rb").read() for d, _, fs in os.walk(bench) for p in fs
             if p in before}
    assert after == before


def test_cell_metrics_follow_workloads_and_moves():
    from harness import core

    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
            "per_layer": [{"name": "m1", "moves": "a", "workloads": ["x"]},
                          {"name": "m2", "moves": "a"}, {"name": "m3", "moves": "b"}]}
    assert [m["name"] for m in core.cell_metrics(spec, "x", "end_to_end")] == ["a", "setup_s"]
    assert [m["name"] for m in core.cell_metrics(spec, "x", "per_layer")] == ["m1", "m2"]
    assert [m["name"] for m in core.cell_metrics(spec, "y", "per_layer")] == []
