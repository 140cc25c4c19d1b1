"""The yardstick's counts against the hand figures of the kernels' table
(PERF.md, the flagship's shapes: 2048 rays, 128 fine / 64 coarse samples,
8x256 fields with the skip at 4, 128-wide heads, 19 classes)."""

import pytest

from harness import yardstick as ys
from harness.core import load_json, program_config
from conftest import BENCH_DIR

FINE = dict(name="fine", depth=8, width=256, skips=(4,), color_width=128, num_classes=19,
            xyz_freqs=10, dir_freqs=4, samples=128)
NPTS = 2048 * 128


def test_trunk_and_field_bounds_match_the_hand_figures():
    x_dim = ys.posenc_dim(3, 10)
    assert x_dim == 63
    b = ys.trunk_fwd_least_ms(NPTS, x_dim, 256, 8, (4,))
    b2 = ys.trunk_bwd_least_ms(NPTS, x_dim, 256, 8, (4,))
    c = ys.field_fwd_least_ms(NPTS, FINE)
    c2 = ys.field_bwd_least_ms(NPTS, FINE)
    assert b == (pytest.approx(0.260, abs=5e-4), "operations")
    assert b2 == (pytest.approx(0.521, abs=5e-4), "operations")
    assert c == (pytest.approx(0.333, abs=5e-4), "operations")
    assert c2 == (pytest.approx(0.666, abs=5e-4), "operations")


def test_intersection_bound_matches_the_hand_figure():
    ms, kind = ys.intersect_least_ms(1, 33088, 32, 25, 0, 16)
    assert kind == "bytes"
    assert ms == pytest.approx(0.0029, abs=5e-5)
    # the bytes are the function's own: rays in, the table in, K intervals out
    assert ys.intersect_io_bytes(1, 33088, 32, 0, 16) == 33088 * 24 + 32 * 57 + 33088 * 16 * 17


def test_trunk_shapes_follow_the_skip():
    shapes = ys.trunk_shapes(63, 256, 8, (4,))
    assert shapes[0] == (63, 256) and shapes[5] == (256 + 63, 256)
    assert all(s == (256, 256) for i, s in enumerate(shapes) if i not in (0, 5))


@pytest.mark.parametrize("name,per_step", [("synthetic_flagship", 1.4830e12),
                                           ("kitti360_panoptic", 1.0119e12)])
def test_step_flops_of_the_configs(name, per_step):
    cfg = program_config(load_json(f"{BENCH_DIR}/configs/{name}.json"), 0)
    assert ys.field_flops(cfg, 2048, backward=True) == pytest.approx(per_step, rel=1e-3)
    fields = ys.fields_of(cfg)
    assert [f["samples"] for f in fields] == [64, 128]
    if name == "kitti360_panoptic":
        assert (fields[0]["depth"], fields[0]["width"], fields[0]["skips"]) == (4, 64, ())
