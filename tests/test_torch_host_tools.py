"""The port's host tools against the JAX package's originals:
`tools.compute_visible_ids` writes the same files byte for byte as
tools/compute_visible_ids.py on tests/test_kitti360.py's handcrafted tree
(run as tests/test_viz_tools.py runs it), and the loader reads them;
`tools.xview_diag` gives the rows of tools/xview_diag.py on a clean demo
tree and its tools/corrupt_pseudo.py clone."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

from test_torch_run_staged import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_compute_visible_ids_matches_jax_tool(tmp_path):
    from panopticnerf_tpu_torch.data.annotation3d import load_visible_ids
    from panopticnerf_tpu_torch.tools import compute_visible_ids
    from test_kitti360 import make_fake_kitti

    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jroot)
    seq = make_fake_kitti(jroot)
    shutil.copytree(jroot, root)
    args = ["--root", jroot, "--sequence", seq, "--max-depth", "50"]
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "compute_visible_ids.py"),
                          *args], capture_output=True, text=True, env=ENV)
    assert res.returncode == 0, res.stderr
    logs = []
    out = compute_visible_ids.main(["--root", root, "--sequence", seq, "--max-depth", "50"],
                                   log=logs.append)
    assert out == os.path.join(root, "visible_id", seq) and "wrote visible_id for" in logs[0]
    ref = _files(os.path.join(jroot, "visible_id", seq))
    assert _files(out) == ref and len(ref) >= 3
    # the car (index 0) is visible at frame 100, the building's window opens at 101
    assert list(load_visible_ids(out, 100)) == [0]
    assert sorted(load_visible_ids(out, 101)) == [0, 1]


def test_xview_diag_matches_jax_tool(tmp_path):
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.tools import xview_diag

    clean, noisy = str(tmp_path / "clean"), str(tmp_path / "noisy")
    write_demo_tree(clean, n_frames=8, hw=(32, 48), n_boxes=4, seed=1, device="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "corrupt_pseudo.py"),
                          "--src", clean, "--dst", noisy, "--frac", "0.2", "--seed", "3"],
                         capture_output=True, text=True, env=ENV)
    assert res.returncode == 0, res.stderr
    grid = "pull:2:0.1:2:0,splat:2:0.1:2:0.8,splat:7:0.05:3:0"
    common = ["--clean", clean, "--noisy", noisy, "--grid", grid,
              "--cfg_file", os.path.join(REPO, "configs", "kitti360_panoptic.yaml")]
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "xview_diag.py"), *common,
                          "--out", str(tmp_path / "jax.json")],
                         capture_output=True, text=True, env=ENV, cwd=REPO)
    assert res.returncode == 0, res.stderr
    ref = json.load(open(tmp_path / "jax.json"))
    out = xview_diag.main([*common, "--out", str(tmp_path / "port.json"), "--device", "cpu"],
                          log=lambda *a: None)
    assert json.load(open(tmp_path / "port.json")) == out
    drop = lambda rows: [{k: v for k, v in r.items() if k != "secs"} for r in rows]
    assert out["pre_clean_noise"] == ref["pre_clean_noise"] > 0
    assert drop(out["grid"]) == drop(ref["grid"]) and len(out["grid"]) == 3
    assert any(r["caught"] > 0 for r in out["grid"])
    assert np.isfinite([r["residual"] for r in out["grid"]]).all()
