"""The port's layout checker (`python -m panopticnerf_tpu_torch.tools.check_data`)
against tools/check_data.py: the report dict of `check_tree` and the verdict
of `diagnose_depth_units` on tests/test_kitti360.py's handcrafted tree and
on a small demo tree with fisheye (the cases of tests/test_viz_tools.py:
missing, partial and optional streams, fisheye flags, the depth units on
float millimetre maps, uint16 PNGs holding metres or millimetres, and one
sparse outlier frame), and the CLI's stdout, stderr and exit code, each
tool run as a subprocess. The test writes its PNGs with PIL; the port
reads them with viz/png.py."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import check_data as jax_check_data  # noqa: E402  (tools/check_data.py)

from panopticnerf_tpu_torch.tools import check_data  # noqa: E402

ENV = dict(os.environ, JAX_PLATFORMS="cpu")
FLAGS = [{}, {"use_fisheye": True}, {"use_stereo": False, "use_pspnet": False},
         {"use_depth": False, "use_fisheye": True}]


def _same_reports(root, seq, frames):
    """check_tree equal to JAX's under every flag set; -> the default report."""
    for flags in FLAGS:
        rep = check_data.check_tree(root, seq, frames, **flags)
        assert rep == jax_check_data.check_tree(root, seq, frames, **flags), flags
    return check_data.check_tree(root, seq, frames)


def _same_units(root, seq, frames):
    out = check_data.diagnose_depth_units(root, seq, frames)
    assert out == jax_check_data.diagnose_depth_units(root, seq, frames)
    return out


@pytest.fixture
def fake_kitti(tmp_path):
    from test_kitti360 import make_fake_kitti

    root = str(tmp_path / "kitti")
    os.makedirs(root)
    return root, make_fake_kitti(root)


def test_check_tree_matches_jax_on_fake_kitti(fake_kitti):
    root, seq = fake_kitti
    frames = [100, 101, 102]
    rep = _same_reports(root, seq, frames)
    assert rep["images/image_00"][0] == "ok" and rep["primitives/3d_bboxes"][0] == "ok"
    assert rep["primitives/visible_id"][:2] == ("partial", False)  # only frame 102
    assert all(st == "ok" for st, req, _ in rep.values() if req)
    rep = check_data.check_tree(root, seq, frames, use_fisheye=True)
    assert rep["images/image_02"][0] == "ok"
    assert rep["images/image_03"][:2] == ("missing", False)
    # a hole in a required stream: partial
    os.remove(os.path.join(root, "data_2d_raw", seq, "image_00", "data_rect", "0000000101.png"))
    assert _same_reports(root, seq, frames)["images/image_00"][0] == "partial"
    # the boxes under train_full/, then none
    xml = os.path.join(root, "data_3d_bboxes", "train", f"{seq}.xml")
    os.makedirs(os.path.join(root, "data_3d_bboxes", "train_full"))
    shutil.move(xml, xml.replace("train", "train_full"))
    assert _same_reports(root, seq, frames)["primitives/3d_bboxes"][0] == "ok"
    shutil.rmtree(os.path.join(root, "data_3d_bboxes"))
    for d in ("sgm", "pspnet", "calibration"):
        shutil.rmtree(os.path.join(root, d))
    rep = _same_reports(root, seq, frames)
    assert {k for k, (st, _, _) in rep.items() if st == "missing"} >= {
        "primitives/3d_bboxes", "depth/sgm", "pseudo_labels/pspnet", "calibration/perspective"}
    # a window past the tree
    _same_reports(root, seq, list(range(200, 264)))


def test_check_tree_matches_jax_on_demo_tree(tmp_path):
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree

    root = str(tmp_path / "tree")
    seq = write_demo_tree(root, n_frames=4, hw=(24, 32), n_boxes=3, fisheye=True, n_concave=1,
                          frame_start=10, device="cpu")
    frames = [10, 11, 12, 13]
    rep = _same_reports(root, seq, frames)
    assert all(st == "ok" for st, _, _ in rep.values())
    rep = check_data.check_tree(root, seq, frames, use_fisheye=True)
    assert all(rep[k][0] == "ok" for k in ("images/image_02", "calibration/fisheye_yaml",
                                           "poses/imu"))
    assert _same_units(root, seq, frames)[0] == "ok"
    assert _same_reports(root, seq, [9, 10])["images/image_00"][0] == "partial"


def test_depth_units_match_jax(fake_kitti):
    from PIL import Image

    root, seq = fake_kitti
    frames = [100, 101, 102]
    sgm = os.path.join(root, "sgm", seq, "image_00")
    stat, msg = _same_units(root, seq, frames)
    assert stat == "ok" and "10.0 m" in msg

    def write(kind, fill, value, dtype=np.float32):
        for fr in frames:
            for ext in (".npy", ".png"):
                if os.path.exists(os.path.join(sgm, f"{fr:010d}{ext}")):
                    os.remove(os.path.join(sgm, f"{fr:010d}{ext}"))
            arr = np.zeros((24, 32), dtype)
            arr[:, :fill] = value
            if kind == "npy":
                np.save(os.path.join(sgm, f"{fr:010d}.npy"), arr)
            else:
                Image.fromarray(arr).save(os.path.join(sgm, f"{fr:010d}.png"))

    write("npy", 16, 10000.0)  # a float map in millimetres
    stat, msg = _same_units(root, seq, frames)
    assert stat == "warn" and "MILLIMETERS" in msg
    write("png", 16, 10, np.uint16)  # a uint16 PNG holding metres: 0.01 m after /1000
    stat, msg = _same_units(root, seq, frames)
    assert stat == "warn" and "small" in msg
    write("png", 20, 12345, np.uint16)  # a uint16 PNG in millimetres, as KITTI-360 ships SGM
    stat, msg = _same_units(root, seq, frames)
    assert stat == "ok" and "12.3 m" in msg
    write("npy", 16, 10.0)  # one sparse far frame does not decide the verdict
    noisy = np.zeros((24, 32), np.float32)
    noisy[0, :4] = 500.0
    np.save(os.path.join(sgm, f"{frames[0]:010d}.npy"), noisy)
    stat, msg = _same_units(root, seq, frames)
    assert stat == "ok" and "3 frames" in msg
    shutil.rmtree(sgm)
    assert _same_units(root, seq, frames)[0] == "none"


def test_cli_matches_jax(fake_kitti):
    """Both CLIs as subprocesses, all started together: stdout, stderr (the
    misspelled flag's argparse message) and exit code equal."""
    root, seq = fake_kitti
    os.remove(os.path.join(root, "data_2d_raw", seq, "image_00", "data_rect", "0000000101.png"))
    cases = {
        "root, a hole in image_00": [
            "--root", root, "--sequence", seq, "--frame_start", "100", "--frame_num", "3"],
        "root, the last frame": [
            "--root", root, "--sequence", seq, "--frame_start", "102", "--frame_num", "1"],
        "cfg_file and overrides": [
            "--cfg_file", os.path.join(REPO, "configs", "kitti360_panoptic.yaml"), "data.root",
            root, "data.frame_start", "102", "data.frame_num", "1", "data.use_fisheye", "true"],
        "overrides only": ["data.root", root, "data.sequence", seq, "data.frame_start", "100",
                           "data.frame_num", "3", "data.use_stereo", "false"],
        "a misspelled flag": ["--root", root, "--frame_strat", "100"],
    }
    procs = {}
    for name, args in cases.items():
        for tool, cmd in (("jax", [os.path.join(REPO, "tools", "check_data.py")]),
                          ("port", ["-m", "panopticnerf_tpu_torch.tools.check_data"])):
            procs[name, tool] = subprocess.Popen([sys.executable, *cmd, *args], cwd=REPO,
                                                 env=ENV, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)
    outs = {k: (*p.communicate(timeout=120), p.returncode) for k, p in procs.items()}
    for name in cases:
        (jout, jerr, jrc), (out, err, rc) = outs[name, "jax"], outs[name, "port"]
        assert (out, rc) == (jout, jrc), name
        if name == "a misspelled flag":
            assert rc == 2 and err == jerr and "unrecognized flag '--frame_strat'" in err
        else:
            assert not err, err
    assert outs["root, a hole in image_00", "port"][2] == outs["overrides only", "port"][2] == 1
    assert outs["root, the last frame", "port"][0].endswith(
        "OK: layout satisfies the configured streams.\n")
    assert "images/image_02" in outs["cfg_file and overrides", "port"][0]
    assert "~ primitives/visible_id" in outs["overrides only", "port"][0]


def test_cli_fails_on_depth_units(fake_kitti, capsys):
    """The depth-unit warning fails the run in both tools (uint16 PNGs in
    metres), and main() returns the exit code it prints the report for."""
    from PIL import Image

    root, seq = fake_kitti
    sgm = os.path.join(root, "sgm", seq, "image_00")
    for fr in (100, 101, 102):
        os.remove(os.path.join(sgm, f"{fr:010d}.npy"))
        arr = np.zeros((24, 32), np.uint16)
        arr[:, :16] = 10
        Image.fromarray(arr).save(os.path.join(sgm, f"{fr:010d}.png"))
    args = ["--root", root, "--sequence", seq, "--frame_start", "100", "--frame_num", "3"]
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "check_data.py"), *args],
                         capture_output=True, text=True, env=ENV)
    assert check_data.main(args) == res.returncode == 1
    out = capsys.readouterr().out
    assert out == res.stdout and " ! depth/units" in out and "FAIL" in out
