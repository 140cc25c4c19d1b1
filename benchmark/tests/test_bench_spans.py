"""The readers of the program's spans and counters (`utils/profiling.py` in the port) on a
synthetic table: what each computes, that each reads None where the program has no such
span (a program without the spans, or a run without device times), and that every
per-layer metric of BENCHMARK.json has its reader."""

import json
import os

import pytest

from conftest import BENCH_DIR
from harness import core
from panopticnerf_tpu_torch.utils import profiling

ROW = {"calls": 0, "host_s": 0.0, "device_calls": 0, "device_ms": 0.0}
STAGES = {"render.intersect": 0.4, "render.sample.coarse": 40.0, "render.sample.fine": 60.0,
          "render.field.coarse": 300.0, "render.field.fine": 1000.0,
          "render.composite.coarse": 100.0, "render.composite.fine": 200.0}


def row(**kw):
    return {**ROW, **kw}


def synthetic_table():
    """Ten kitti360-sized views, four of them timed on the device; the loader's spans, a
    decode outside make_dataset (not counted), two kernel loads."""
    snap = {("render.view", None): row(calls=10, host_s=5.0, device_calls=4, device_ms=1800.0),
            ("render.rays", "render.view"): row(calls=10 * 132352),
            ("render.rays_padded", "render.view"): row(calls=10 * 2816),
            ("data.make_dataset", None): row(calls=1, host_s=4.0),
            ("data.decode", "data.make_dataset"): row(calls=80, host_s=0.15),
            ("data.decode", None): row(calls=3, host_s=9.0),
            ("data.resize", "data.make_dataset"): row(calls=80, host_s=3.5),
            ("data.boxes", "data.make_dataset"): row(calls=17, host_s=0.05),
            ("kernels.load", "render.intersect"): row(calls=1, host_s=0.02),
            ("kernels.load", None): row(calls=1, host_s=0.01)}
    for name, ms in STAGES.items():
        snap[(name, "render.view")] = row(calls=330, host_s=0.1, device_calls=132, device_ms=ms)
    return snap


def use_table(monkeypatch, snap):
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap))
    monkeypatch.setattr(profiling, "calls",
                        lambda name: sum(r["calls"] for (n, _), r in snap.items() if n == name))


def read(name):
    return core.metric_reader(name).read({})


def test_the_readers_on_a_synthetic_table(monkeypatch):
    use_table(monkeypatch, synthetic_table())
    assert read("render_sampling_ms.render") == pytest.approx(100.0 / 4)
    assert read("render_field_ms.render") == pytest.approx(1300.0 / 4)
    assert read("render_composite_ms.render") == pytest.approx(300.0 / 4)
    assert read("render_self_ms.render") == pytest.approx((1800.0 - sum(STAGES.values())) / 4)
    assert read("render_padding_pct.render") == pytest.approx(100.0 * 2816 / (132352 + 2816))
    assert read("make_dataset_s") == pytest.approx(4.0)
    assert read("png_decode_s") == pytest.approx(0.15)
    assert read("image_resize_s") == pytest.approx(3.5)
    assert read("kernel_load_s") == pytest.approx(0.03)


def test_the_padding_of_both_render_cells():
    """The padding arithmetic of `render_image_rays` at the cells' view sizes and the tiles
    their configurations give: none at 188x704 or 94x352 in tiles of 33,088 rays (at the
    shipped 4096 it was 2.08 % and 10.24 %)."""
    for name, (h, w), pct in (("kitti360_panoptic", (188, 704), 0.0),
                              ("synthetic_flagship", (94, 352), 0.0)):
        conf = core.load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))
        tile, n = conf["program"]["render"]["ray_tile"], h * w
        padded = -n % tile
        assert round(100.0 * padded / (n + padded), 2) == pct
    for (h, w), pct in (((188, 704), 2.08), ((94, 352), 10.24)):
        padded = -(h * w) % 4096
        assert round(100.0 * padded / (h * w + padded), 2) == pct


NAMES = ["render_sampling_ms.render", "render_field_ms.render", "render_composite_ms.render",
         "render_self_ms.render", "render_padding_pct.render", "make_dataset_s",
         "png_decode_s", "image_resize_s", "kernel_load_s"]


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_none_where_nothing_was_recorded(monkeypatch, name):
    """No device times (the CPU, or no profiled view), no loader spans (the procedural
    scene), or a program whose profiling module has no table at all."""
    snap = {k: {**r, "device_calls": 0, "device_ms": 0.0} for k, r in synthetic_table().items()
            if not k[0].startswith(("data.", "kernels.", "render.rays"))}
    use_table(monkeypatch, snap)
    assert read(name) is None
    monkeypatch.delattr(profiling, "snapshot")
    monkeypatch.delattr(profiling, "calls")
    assert read(name) is None


def test_every_per_layer_metric_has_a_reader():
    spec = json.load(open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")), m["name"]
    assert {m["name"] for m in spec["per_layer"]} >= set(NAMES)
