"""The hybrid-field cell `kitti360-grid-render` (configuration `kitti360_grid`, reference
`reference/hybrid.py`), on the CPU at a small size: found and run by name through the
harness as it is; the draw and view of the existing configurations unmoved by the new
reference; the control failing and the program passing the cell's limits; the grid's faults
(every table zeroed, one level's lookup dropped) reading above a limit on every seed; the
cell's new readers."""

import contextlib
import io
import json
import os

import pytest
import torch

import grid_faults
import readings
import run
from conftest import BENCH_DIR, SMALL
from harness import core
from test_bench_pinned import WEIGHTS, conf_file, digest

ROOT = os.path.dirname(BENCH_DIR)
CELL = "kitti360-grid-render"
LIMITS = json.load(open(os.path.join(BENCH_DIR, "limits", f"{CELL}.json")))


def test_the_cell_is_found_by_name_and_runs():
    """BENCHMARK.json's entries and the new files are all the cell needs: the harness names
    no configuration, reference or grid, and the run is correct with the program's maps."""
    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, conf, conf_f = core.find_cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("kitti360_grid", "render", 1)
    assert core.reference(conf_f).__name__ == "reference.hybrid"
    harness = os.path.join(BENCH_DIR, "harness")
    for fn in os.listdir(harness):
        if fn.endswith(".py"):
            src = open(os.path.join(harness, fn)).read()
            assert not any(w in src for w in ("hybrid", "kitti360_grid", "grid_")), fn
    layer = {m["name"] for m in core.cell_metrics(bench, CELL, "per_layer")}
    assert {"grid_roofline.render", "render_grid_ms.render", "mfu_grid.render"} <= layer
    assert "mfu.render" not in layer
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", CELL, "--seed", "3000000001", "--seconds", "1",
                       "--trace", "0"], device="cpu", overrides=SMALL)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"render_rays_per_s", "setup_s"}
    assert set(line["checks"]) == set(LIMITS)


@pytest.mark.parametrize("name,seed", sorted(WEIGHTS))
def test_the_new_reference_leaves_the_pinned_draws(name, seed):
    """With reference.hybrid loaded beside reference.nerf, nerf's configurations draw the
    weights test_bench_pinned pins, and the hybrid draw holds every Dense of the nerf draw's
    shapes but the three widened heads. The draw runs on one thread: under load the bits of a
    many-threaded draw were seen to move (ATen's erfinv splits the tensor among the threads
    it gets, and its vector and scalar paths can round apart)."""
    hybrid = core.reference(conf_file("kitti360_grid"))
    conf = conf_file(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = core.reference(conf).make_weights(conf["program"], seed, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert digest(weights) == WEIGHTS[(name, seed)]
    shapes = hybrid.param_shapes(conf_file("kitti360_grid")["program"])
    plain = core.reference(conf_file("kitti360_panoptic")).param_shapes(
        conf_file("kitti360_panoptic")["program"])
    widened = {k for k in plain if plain[k] != shapes[k]}
    assert widened == {f"{f}.{h}.weight" for f in ("coarse", "fine")
                       for h in ("sigma", "sem_hidden", "feature")}
    assert all(shapes[k][1] == plain[k][1] + 32 for k in widened)
    assert len([k for k in shapes if ".grid.table_" in k]) == 32


def test_the_control_fails_and_the_program_passes():
    torch.set_num_threads(2)
    with contextlib.redirect_stdout(io.StringIO()):
        rec = readings.main(["--workload", CELL, "--seeds", "2"], device="cpu",
                            overrides=SMALL)[0]
    assert all(rec["program"][k] <= v for k, v in LIMITS.items())
    assert any(rec["control"][k] > v for k, v in LIMITS.items())
    assert any(rec["half_batch"][k] > v for k, v in LIMITS.items())


@pytest.mark.parametrize("level", [0, 15])
def test_the_grid_faults_read_above_a_limit_on_every_seed(level):
    """The program's tables zeroed after the seeded draw (the grid skipped), and one
    level's table zeroed (its lookup dropped), each read above at least one limit on
    every seed, while the program itself keeps them all."""
    torch.set_num_threads(2)
    with contextlib.redirect_stdout(io.StringIO()):
        recs = grid_faults.main(["--workload", CELL, "--seeds", "1,2,3", "--level", str(level)],
                                device="cpu", overrides=SMALL)
    for rec in recs:
        assert all(rec["program"][k] <= v for k, v in LIMITS.items()), rec
        for fault in ("zero_tables", "drop_level"):
            assert any(rec[fault][k] > v for k, v in LIMITS.items()), (fault, rec)


def _cfg():
    return core.program_config(conf_file("kitti360_grid"), 0)


def test_the_grid_readers():
    """grid_roofline.render: G's least time (its own bytes at HBM's rate, 12 in and 64 out a
    point, which bound it over ~60 f32 operations a point and level) over its device time;
    mfu_grid.render: the hybrid Dense FLOPs over the view time and the bf16 peak, above
    mfu.render's count of the plain shapes by the heads' 32 more columns; both None for a
    configuration without a grid."""
    cfg, n = _cfg(), 188 * 704
    points = n * (64 + 128)
    ctx = {"cfg": cfg, "n_rays": n, "window": {"units": 10, "seconds": 1.0},
           "trace": {"units": 2, "layers": {"grid_encoding": {"seconds": 0.02}}}}
    least_s = points * 76 / 3.35e12
    roof = core.metric_reader("grid_roofline.render").read(ctx)
    assert roof == pytest.approx(100.0 * least_s * 2 / 0.02)
    mfu = core.metric_reader("mfu_grid.render").read(ctx)
    plain = core.metric_reader("mfu.render").read(ctx)
    extra = 2.0 * n * (64 * 32 * (32 + 1 + 64) + 128 * 32 * (128 + 1 + 256)) * 10 / 989e12
    assert mfu == pytest.approx(plain + 100.0 * extra)
    nogrid = dict(ctx, cfg=core.program_config(conf_file("kitti360_panoptic"), 0))
    assert core.metric_reader("grid_roofline.render").read(nogrid) is None
    assert core.metric_reader("mfu_grid.render").read(nogrid) is None


def test_the_grid_span_reader(monkeypatch):
    """render_grid_ms.render: device ms of `render.grid.<level>` inside `render.field.<level>`
    per device-timed view; None without device times or without the spans (the parent)."""
    from panopticnerf_tpu_torch.utils import profiling

    row = {"calls": 8, "host_s": 0.01, "device_calls": 4, "device_ms": 0.0}
    snap = {("render.view", None): dict(row, calls=2, device_calls=2, device_ms=200.0),
            ("render.grid.coarse", "render.field.coarse"): dict(row, device_ms=9.0),
            ("render.grid.fine", "render.field.fine"): dict(row, device_ms=17.0)}
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap))
    read = core.metric_reader("render_grid_ms.render").read
    assert read({}) == pytest.approx(13.0)
    del snap[("render.grid.coarse", "render.field.coarse")], snap[("render.grid.fine",
                                                                  "render.field.fine")]
    assert read({}) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read({}) is None
