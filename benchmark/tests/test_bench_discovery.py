"""The harness finds a configuration, its reference, a traffic mix, a per-layer metric and a
kernel-name list by name: each is added as a new file, and no file the benchmark already has
is edited."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, SMALL

# nerf's field with another draw: every bias a seeded value in [-0.1, 0.1), so that a draw
# that reached only one side reads as a gap; its field counts its calls
PROBE_REF = '''
from functools import partial

import torch

from reference import nerf
from reference.nerf import fp8_quant, leaf_gap, quiet_leaves  # noqa: F401

CALLS = []


def field(params, cfg, level, pts, dirs, quant=None):
    CALLS.append(level)
    return nerf.field_apply(params, cfg, level, pts, dirs, quant)


render_view = partial(nerf.render_view, field=field)
Trainer = partial(nerf.Trainer, field=field)


def make_weights(conf_program, seed, device):
    out = nerf.make_weights(conf_program, seed, device)
    biases = [k for k in out if k.endswith(".bias")]
    g = torch.Generator(device).manual_seed(seed + 1)
    flat = torch.rand(sum(out[k].numel() for k in biases), generator=g, device=device) * 0.2 - 0.1
    at = 0
    for k in biases:
        out[k] = flat[at:at + out[k].numel()].view(out[k].shape)
        at += out[k].numel()
    return out
'''

PROBE = r"""
import contextlib, io, json, sys
sys.path[:0] = [sys.argv[1]]
sys.path.append(sys.argv[3])
import torch
import run
from harness import core
bench = core.load_json(sys.argv[2])
cell, conf, conf_file = core.find_cell(bench, "probe-cell")
ref = core.reference(conf_file)
weights = ref.make_weights(conf_file["program"], 5, "cpu")
torch.set_num_threads(2)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = run.main(["--workload", "probe-render", "--seed", "3000000001", "--seconds", "1",
                   "--trace", "0"], device="cpu", overrides=json.loads(sys.argv[4]))
print(json.dumps({
    "config": conf_file["name"], "traffic": core.load_traffic(cell["traffic"])["kind"],
    "reference": ref.__name__,
    "biases_drawn": all(bool(w.abs().min() > 0) for k, w in weights.items() if k.endswith("bias")),
    "metrics": [m["name"] for m in core.cell_metrics(bench, "probe-cell", "per_layer")],
    "read": core.metric_reader("probe_metric.train").read({"x": 3}),
    "layers": core.kernel_patterns()["probe_layer"],
    "rc": rc, "line": json.loads(out.getvalue().strip().splitlines()[-1]),
    "field_levels": sorted(set(ref.CALLS))}))
"""


def files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = files(bench)
    conf = json.load(open(bench / "configs" / "synthetic_flagship.json"))
    conf.update(name="probe_config", reference="probe_ref")
    (bench / "configs" / "probe_config.json").write_text(json.dumps(conf))
    (bench / "reference" / "probe_ref.py").write_text(PROBE_REF)
    (bench / "limits" / "probe-render.json").write_text(
        (bench / "limits" / "flagship-render.json").read_text())
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
    spec["workloads"] += [{"name": "probe-cell", "config": "probe_config",
                           "traffic": "probe_mix", "chips": 1, "why": "probe"},
                          {"name": "probe-render", "config": "probe_config",
                           "traffic": "render", "chips": 1, "why": "probe"}]
    spec["end_to_end"].append({"name": "probe_rate", "unit": "1/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["probe-cell"]})
    spec["end_to_end"][0]["workloads"].append("probe-render")
    spec["per_layer"].append({"name": "probe_metric.train", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "probe", "moves": "probe_rate",
                              "workloads": ["probe-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", PROBE, str(bench), str(tmp_path / "BENCHMARK.json"),
                          os.path.dirname(BENCH_DIR), json.dumps(SMALL)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    line = got.pop("line")
    assert got == {"config": "probe_config", "traffic": "train", "reference": "reference.probe_ref",
                   "biases_drawn": True, "metrics": ["probe_metric.train"], "read": 6,
                   "layers": ["probe_kernel"], "rc": 0, "field_levels": [0, 1]}
    # the program rendered with the probe's draw: its maps keep the cell's limits
    assert line["correct"] is True, line["checks"]
    assert files(bench).items() >= before.items()


def test_cell_metrics_follow_workloads_and_moves():
    from harness import core

    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
            "per_layer": [{"name": "m1", "moves": "a", "workloads": ["x"]},
                          {"name": "m2", "moves": "a"}, {"name": "m3", "moves": "b"}]}
    assert [m["name"] for m in core.cell_metrics(spec, "x", "end_to_end")] == ["a", "setup_s"]
    assert [m["name"] for m in core.cell_metrics(spec, "x", "per_layer")] == ["m1", "m2"]
    assert [m["name"] for m in core.cell_metrics(spec, "y", "per_layer")] == []
