"""The panorama cell `kitti360-360-panorama` (configuration `kitti360_360_grid`, traffic
`panorama`, driver `harness/panorama.py`, reference `reference/hybrid360.py`), on the CPU at a
small size (the cell's configuration narrowed by `SMALL`, its 512x1024 panorama cut to 16x32):
found and run by name through the harness as it is, reporting `render_rays_per_s`; the control
and every fault (the half batch, the altered answer, the grid's tables zeroed and a level
dropped) reading above a limit while the program keeps them all; the new reader; the
reference's rays for one seed pinned by SHA-256."""

import contextlib
import io
import json
import os
import tempfile

import pytest
import torch

import grid_faults
import readings
import run
from conftest import BENCH_DIR, SMALL
from harness import core
from test_bench_pinned import conf_file, digest

ROOT = os.path.dirname(BENCH_DIR)
CELL = "kitti360-360-panorama"
LIMITS = json.load(open(os.path.join(BENCH_DIR, "limits", f"{CELL}.json")))
# the reference's rays of view 0 of the small scene of seed 3000000001, at the traffic's
# 512x1024; they pass through ATen's CPU sin / cos, recorded on torch 2.13.0+cpu with AVX512
RAYS = "848b63e03f2ff984a2e17da303f0ff20595c913a9e70fc46c523922e26b8fb72"


@pytest.fixture
def small_panorama(monkeypatch):
    """The panorama traffic at 16x32 (512 rays, one tile of SMALL's 512)."""
    real = core.load_traffic
    monkeypatch.setattr(core, "load_traffic",
                        lambda name: dict(real(name), hw=[16, 32]) if name == "panorama"
                        else real(name))
    torch.set_num_threads(2)


def _run(fault=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", CELL, "--seed", "3000000001", "--seconds", "1",
                       "--trace", "0"], device="cpu", overrides=SMALL, fault=fault)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_cell_is_found_by_name_and_runs(small_panorama):
    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _, conf_f = core.find_cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("kitti360_360_grid", "panorama", 1)
    assert core.reference(conf_f).__name__ == "reference.hybrid360"
    assert core.load_traffic("panorama")["kind"] == "panorama"
    layer = {m["name"] for m in core.cell_metrics(bench, CELL, "per_layer")}
    assert {"render_panorama_rays_ms.render", "render_grid_ms.render", "grid_roofline.render",
            "mfu_grid.render", "composite_roofline.render", "intersect_roofline.render",
            "render_sampling_fused_pct.render", "render_composite_fused_pct.render",
            "render_padding_pct.render"} <= layer
    assert "mfu.render" not in layer
    line = _run()
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"render_rays_per_s", "setup_s"}
    assert line["metrics"]["render_rays_per_s"]["value"] > 0
    assert set(line["checks"]) == set(LIMITS)


@pytest.mark.parametrize("fault", ["half_batch", "alter_answer"])
def test_the_faults_read_above_a_limit(small_panorama, fault):
    line = _run(fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values()), line["checks"]


def test_the_control_and_the_grid_faults_fail_and_the_program_passes(small_panorama):
    """readings.py's control, half batch and altered answer, and grid_faults.py's tables
    zeroed and level 0 dropped (its reader, given this cell's driver: its command line takes
    render cells only), each above a limit on seed 2; the program within every limit."""
    with contextlib.redirect_stdout(io.StringIO()):
        rec = readings.main(["--workload", CELL, "--seeds", "2"], device="cpu",
                            overrides=SMALL)[0]
    conf = core.merged(conf_file("kitti360_360_grid"), SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = {"device": "cpu", "sync": lambda: None, "seeds": core.sub_seeds(2), "conf": conf,
               "traffic": core.load_traffic("panorama"), "tmpdir": tmp}
        grid = grid_faults.read_grid_faults(ctx, core.driver("panorama"), 0)
    for program in (rec["program"], grid["program"]):
        assert all(program[k] <= v for k, v in LIMITS.items()), program
    for fault in (rec["control"], rec["half_batch"], rec["alter_answer"], grid["zero_tables"],
                  grid["drop_level"]):
        assert any(fault[k] > v for k, v in LIMITS.items()), fault


def test_the_reference_rays_are_pinned():
    conf = core.merged(conf_file("kitti360_360_grid"), SMALL)
    ref = core.reference(conf)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _, ds, _, _ = core.build_dataset(conf, core.sub_seeds(3000000001), tmp, "cpu",
                                             lambda: None)
        c2w = ds.c2w[0]
        o, d = ref.panorama_rays(c2w[:, 3], c2w[:, :3], 512, 1024)
    finally:
        torch.set_num_threads(threads)
    assert o.shape == d.shape == (512 * 1024, 3)
    host = (torch.__version__, torch.backends.cpu.get_cpu_capability())
    assert digest({"o": o, "d": d}) == RAYS, f"recorded on torch 2.13.0+cpu, AVX512; run on {host}"


def test_the_panorama_span_reader(monkeypatch):
    """render_panorama_rays_ms.render: device ms of `render.panorama.rays` inside
    `render.panorama` per device-timed panorama; None without device times or without the
    spans (the parent)."""
    from panopticnerf_tpu_torch.utils import profiling

    row = {"calls": 4, "host_s": 0.01, "device_calls": 2, "device_ms": 0.0}
    snap = {("render.panorama", None): dict(row, device_ms=600.0),
            ("render.panorama.rays", "render.panorama"): dict(row, device_ms=0.25),
            ("render.view", "render.panorama"): dict(row, device_ms=590.0)}
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap))
    read = core.metric_reader("render_panorama_rays_ms.render").read
    assert read({}) == pytest.approx(0.125)
    del snap[("render.panorama.rays", "render.panorama")]
    assert read({}) is None
    snap[("render.panorama.rays", "render.panorama")] = dict(row, device_ms=0.25)
    snap[("render.panorama", None)] = dict(row, device_calls=0)
    assert read({}) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read({}) is None
