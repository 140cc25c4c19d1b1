"""The staged training recipe as one chained run (port of tools/run_staged.py).

Each stage warm-starts from the weights of the stage before it
(`train.init_from`), widening from bare RGB to the full panoptic objective:

  1. kitti360_rgb_coarse          geometry + rgb, coarse only
  2. kitti360_hierarchical_depth  + fine field + sparse-depth loss
  3. kitti360_semantic            + dual semantic fields + pseudo filter
  4. kitti360_panoptic            the joint panoptic objective

    python -m panopticnerf_tpu_torch.run_staged --root datasets/KITTI-360 [--steps 2000] \\
        [KEY VALUE ...]
    python -m panopticnerf_tpu_torch.run_staged --synthesize-tree /tmp/minikitti --steps 50

Every stage trains, is evaluated and keeps its own checkpoints under
`<model_dir>/torch/<task>/<exp_name>/` (engine.port_roots), which the next
stage warm-starts from, so any stage can be re-run or evaluated on its
own. The warm start copies each parameter whose name and shape match and
keeps the fresh init elsewhere: the coarse-only stages' field lands in the
next model's coarse field; a shape that differs is warned about. Runs on
the first CUDA device unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

STAGES = [
    "kitti360_rgb_coarse",
    "kitti360_hierarchical_depth",
    "kitti360_semantic",
    "kitti360_panoptic",
]

# the -360 continuation: the panoptic model warm-starts the joint
# perspective + fisheye objective
STAGE_360 = "kitti360_360"


def tree_presets(tree_dir, n_frames=8, hw=(48, 64), n_boxes=6, n_concave=0):
    """KEY VALUE presets for a demo tree of the given scale (no IO): the
    padded primitive capacity covers the boxes and the ground plane, rounded
    up to a multiple of 8 (at least 16), and denser box soups get a deeper
    interval budget. Each concave L-building is 2 convex records."""
    n_prims = n_boxes + 1 + 2 * n_concave  # + ground plane
    n_eff = n_boxes + 2 * n_concave
    return ["data.root", tree_dir,
            "data.frame_start", "0",
            "data.frame_num", str(n_frames),
            "data.test_every", "4",
            "data.max_primitives", str(max(16, -(-n_prims // 8) * 8)),
            "data.max_intervals", str(8 if n_eff <= 12 else 12),
            "data.ratio", "1.0",
            "render.far", "40.0"]


def stage_cfg(name, prev_ckpt, steps, common, user_keys, proposal=None):
    """One stage's config (no training): presets < stage defaults < the
    user's KEY VALUE options. Returns (cfg, notes), notes being readable
    lines on what was derived."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.config.config import merge_from_list
    from panopticnerf_tpu_torch.models.nerf import coarse_field_cfg

    notes = []
    cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml"))
    if proposal:
        # a small coarse field across the chain: the coarse-only stage
        # trains its one field at that size (coarse_field_cfg: the names and
        # shapes of the later stages' coarse field), so it merges on warm start
        d, w = proposal
        if cfg.render.n_importance > 0:
            cfg.model.coarse_trunk_depth = d
            cfg.model.coarse_trunk_width = w
            notes.append(f"proposal coarse {d}x{w}")
        else:
            eff = coarse_field_cfg(
                dataclasses.replace(cfg.model, coarse_trunk_depth=d, coarse_trunk_width=w),
                has_fine=True)
            cfg.model.trunk_depth = eff.trunk_depth
            cfg.model.trunk_width = eff.trunk_width
            cfg.model.skips = eff.skips
            cfg.model.color_width = eff.color_width
            notes.append(f"coarse-only stage trains the proposal field {d}x{w}")
    # stage defaults before the merge, so that the user's options win
    cfg.train.resume = False
    if prev_ckpt and "train.init_from" not in user_keys:
        cfg.train.init_from = prev_ckpt
        # the chain is the geometry pretraining: a gate left on would zero
        # the semantic losses for pretrain_steps, all of a short run
        if cfg.train.pretrain and "train.pretrain" not in user_keys:
            cfg.train.pretrain = ""
            notes.append("warm-chained: in-run pretrain gate dropped")
    merge_from_list(cfg, common)
    if steps:
        cfg.train.max_steps = steps
        cfg.train.epochs = max(1, steps // cfg.train.ep_iter)
        if (cfg.train.pretrain and cfg.train.pretrain_steps >= steps
                and "train.pretrain_steps" not in user_keys
                and "pretrain_steps" not in user_keys):
            # an unchained short run: geometry half, joint half
            cfg.train.pretrain_steps = steps // 2
            notes.append(f"pretrain_steps scaled to {cfg.train.pretrain_steps} "
                         f"to fit --steps {steps}")
    return cfg, notes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="staged PanopticNeRF pipeline")
    p.add_argument("--root", default=None, help="KITTI-360 tree (data.root)")
    p.add_argument("--synthesize-tree", default=None, metavar="DIR",
                   help="write the miniature KITTI-360 demo tree there and use it")
    p.add_argument("--steps", type=int, default=0,
                   help="train.max_steps of every stage (0 = each config's)")
    p.add_argument("--stages", type=int, default=0,
                   help="run only the first N stages (0 = all)")
    p.add_argument("--fisheye", action="store_true",
                   help="append the -360 stage (kitti360_360) after the panoptic stage; "
                        "with --synthesize-tree the tree also gets fisheye image_02 streams")
    p.add_argument("--tree-frames", type=int, default=8,
                   help="frames in the synthesized tree (with --synthesize-tree)")
    p.add_argument("--tree-hw", default="48,64", metavar="H,W",
                   help="image size of the synthesized tree")
    p.add_argument("--tree-boxes", type=int, default=6,
                   help="bounding primitives in the synthesized tree")
    p.add_argument("--tree-concave", type=int, default=0,
                   help="concave L-shaped buildings in the synthesized tree (2 convex records "
                        "each)")
    p.add_argument("--proposal", default=None, metavar="D,W",
                   help="a small D x W coarse field for the whole chain (the coarse-only "
                        "first stage trains its one field at D x W)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the stages train and evaluate (and the tree's raycast runs)")
    # KEY VALUE overrides may come between flags; a leftover --token is a
    # misspelled flag
    args, opts = p.parse_known_args(argv)
    for tok in opts:
        if tok.startswith("--"):
            p.error(f"unrecognized flag {tok!r}")
    args.opts = opts
    return args


def common_options(args) -> list:
    """Every stage's KEY VALUE options: the tree's presets first, the user's
    last (merge_from_list: the last wins)."""
    presets = []
    if args.synthesize_tree:
        hw = tuple(int(x) for x in args.tree_hw.split(","))
        presets = tree_presets(args.synthesize_tree, args.tree_frames, hw, args.tree_boxes,
                               args.tree_concave)
    elif args.root:
        presets = ["data.root", args.root]
    return presets + list(args.opts)


def run_chain(args, log=print):
    """Train and evaluate each stage of `args` (parse_args) in turn, each
    warm-starting from the last. Yields one record per stage: `name`,
    `cfg`, `notes`, `train` (engine.run_train's result), `eval`
    (run_evaluate's), `train_seconds`, `eval_seconds` (host clock)."""
    from panopticnerf_tpu_torch import engine

    if args.synthesize_tree:
        from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree

        os.makedirs(args.synthesize_tree, exist_ok=True)
        write_demo_tree(args.synthesize_tree, n_frames=args.tree_frames,
                        hw=tuple(int(x) for x in args.tree_hw.split(",")),
                        n_boxes=args.tree_boxes, fisheye=args.fisheye,
                        n_concave=args.tree_concave, device=args.device)
    common = common_options(args)
    user_keys = set(args.opts[::2])

    stages = list(STAGES) + ([STAGE_360] if args.fisheye else [])
    if args.stages:
        stages = stages[: args.stages]
    proposal = tuple(int(x) for x in args.proposal.split(",")) if args.proposal else None
    prev_ckpt = ""
    for name in stages:
        cfg, notes = stage_cfg(name, prev_ckpt, args.steps, common, user_keys,
                               proposal=proposal)
        log(f"=== stage {name} "
            f"({'warm from ' + prev_ckpt if prev_ckpt else 'from scratch'}) ===")
        for n in notes:
            log(f"  ({n})")
        t0 = time.perf_counter()
        train = engine.run_train(cfg, args.device, max_steps=args.steps or None, log=log)
        t1 = time.perf_counter()
        res = engine.run_evaluate(cfg, args.device, log=log)
        yield {"name": name, "cfg": cfg, "notes": notes, "train": train, "eval": res,
               "train_seconds": t1 - t0, "eval_seconds": time.perf_counter() - t1}
        prev_ckpt = engine.port_roots(cfg).steps


def main(argv=None, log=print) -> dict:
    """Run the chain; returns {stage: its numeric evaluation metrics}."""
    args = parse_args(argv)
    results, walls = {}, {}
    for rec in run_chain(args, log):
        results[rec["name"]] = {k: v for k, v in rec["eval"].items()
                                if isinstance(v, (int, float))}
        walls[rec["name"]] = (f"train {rec['train_seconds']:.1f} s, "
                              f"evaluate {rec['eval_seconds']:.1f} s")
    log("=== staged pipeline summary ===")
    for name, res in results.items():
        log(f"  {name}: " + ", ".join(f"{k}={v:.3f}" for k, v in res.items())
            + f" ({walls[name]})")
    return results


if __name__ == "__main__":
    main()
