"""The full-resolution protocol that tools/fullres_protocol_torch.py runs on
the card is the one the JAX package's records came from: for each arm, the
tree's presets (`tree_presets(..., 8, (376, 1408), 16, 4)`) and every
stage's config (`stage_cfg`) equal tools/run_staged.py's for the same flags
(`--proposal 4,64`, `--fisheye`), and the 10k continuation's config equals
the one of the JAX scripts' options (tools/r5_p64_defense.sh for arm a,
tools/r4_chain.sh for arm b), field for field."""

import dataclasses
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import fullres_protocol_torch as protocol  # noqa: E402  (tools/fullres_protocol_torch.py)
import run_staged as jax_run_staged  # noqa: E402  (tools/run_staged.py)

from panopticnerf_tpu_torch import run_staged  # noqa: E402
from panopticnerf_tpu_torch.config.config import without_port_only  # noqa: E402

TREE = "/t"
# the JAX scripts' options of the 10k continuation: PRE and ARM
JAX_PRE = ["data.root", TREE, "data.frame_start", "0", "data.frame_num", "8",
           "data.test_every", "4", "data.max_primitives", "32", "data.max_intervals", "12",
           "data.ratio", "1.0", "render.far", "40.0"]
JAX_SCHEDULE = ["train.pretrain", "", "train.max_steps", "10000", "train.epochs", "20",
                "train.ep_iter", "500", "train.eval_ep", "4", "train.eval_views", "8"]
JAX_COARSE = {"a": ["model.coarse_trunk_depth", "4", "model.coarse_trunk_width", "64"],
              "b": ["model.coarse_trunk_depth", "0", "model.coarse_trunk_width", "0"]}
STAGES = {"a": run_staged.STAGES[:3], "b": run_staged.STAGES[:3],
          "c": run_staged.STAGES + [run_staged.STAGE_360]}


def test_tree_presets_at_full_resolution():
    presets = run_staged.tree_presets(TREE, 8, (376, 1408), 16, 4)
    assert presets == jax_run_staged.tree_presets(TREE, 8, (376, 1408), 16, 4)
    assert presets == JAX_PRE  # P = 16 + 1 + 2 * 4 -> 32, K = 12, full size, far 40 m


@pytest.mark.parametrize("arm", sorted(protocol.ARMS))
def test_protocol_configs_match_jax(arm):
    from panopticnerf_tpu.config.config import load_config as jax_load_config
    from panopticnerf_tpu_torch.config import load_config

    args = run_staged.parse_args(protocol.staged_argv(arm, TREE, 2000, "cuda", []))
    assert (args.tree_hw, args.tree_frames, args.tree_boxes, args.tree_concave) == (
        "376,1408", 8, 16, 4)
    assert args.fisheye == (arm == "c") and args.proposal == ("4,64" if arm == "a" else None)
    # tools/run_staged.py's main, step by step, on the same flags
    jcommon = jax_run_staged.tree_presets(TREE, 8, (376, 1408), 16, 4) + list(args.opts)
    common = run_staged.common_options(args)
    assert common == jcommon
    stages = list(run_staged.STAGES) + ([run_staged.STAGE_360] if args.fisheye else [])
    stages = stages[:args.stages] if args.stages else stages
    assert stages == STAGES[arm]
    proposal = tuple(int(x) for x in args.proposal.split(",")) if args.proposal else None
    user_keys, prev = set(args.opts[::2]), ""
    for name in stages:
        jcfg, jnotes = jax_run_staged.stage_cfg(name, prev, 2000, jcommon, user_keys,
                                                proposal=proposal)
        cfg, notes = run_staged.stage_cfg(name, prev, 2000, common, user_keys,
                                          proposal=proposal)
        assert without_port_only(dataclasses.asdict(cfg)) == dataclasses.asdict(jcfg), name
        assert notes == jnotes and cfg.model.hash_grid is False, name
        d = cfg.data
        assert (d.root, d.frame_num, d.max_primitives, d.max_intervals, d.ratio,
                cfg.render.far, cfg.train.max_steps) == (TREE, 8, 32, 12, 1.0, 40.0, 2000)
        assert d.use_fisheye == (name == run_staged.STAGE_360)
        if proposal and cfg.render.n_importance > 0:
            assert (cfg.model.coarse_trunk_depth, cfg.model.coarse_trunk_width) == proposal
        prev = f"{name}/ckpt"
    if arm == "c":  # the -360 stage on the tree's one sequence
        assert cfg.data.sequences == ("2013_05_28_drive_0000_sync",)
        return
    lopts = protocol.long_opts(arm, TREE, prev, 10000)
    jopts = [*JAX_PRE, *JAX_COARSE[arm], *JAX_SCHEDULE, "train.init_from", prev,
             "exp_name", "kitti360_panoptic_10k"]
    cfg = load_config(protocol.CFG_FILE, lopts)
    assert without_port_only(dataclasses.asdict(cfg)) == dataclasses.asdict(
        jax_load_config(protocol.CFG_FILE, jopts))
    assert (cfg.train.eval_ep * cfg.train.ep_iter, cfg.train.save_best, cfg.train.pretrain,
            cfg.render.eval_keep_samples) == (2000, True, "", 0)
