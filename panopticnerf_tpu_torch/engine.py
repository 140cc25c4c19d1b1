"""Evaluation entry point (port of the `run_evaluate` path of
`panopticnerf_tpu/engine.py`).

`run_evaluate` builds the dataset on a device, restores a converted
checkpoint, renders every evaluated view (intersection kernel, then the
tiled render) and scores PSNR / mIoU / PQ. Training, visualisation and the
throughput probe are not ported yet.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.convert import load_npz
from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
from panopticnerf_tpu_torch.eval import make_evaluator
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops.intersect import intersect_rays
from panopticnerf_tpu_torch.render import SceneBounds, render_image_rays


def checkpoint_path(cfg: Config) -> tuple[str, int]:
    """The converted checkpoint `<model_dir>/torch/<exp_name>_<step>.npz`
    to evaluate: step train.eval_step, or the latest when it is 0."""
    if cfg.train.eval_step < 0:
        raise NotImplementedError("train.eval_step -1 (best checkpoint) is not ported yet")
    root = os.path.join(cfg.model_dir, "torch")
    pat = re.compile(re.escape(cfg.exp_name) + r"_(\d+)\.npz$")
    steps = sorted(int(m.group(1)) for f in (os.listdir(root) if os.path.isdir(root) else [])
                   if (m := pat.match(f)))
    want = cfg.train.eval_step or (steps[-1] if steps else None)
    if want is None or want not in steps:
        raise FileNotFoundError(
            f"no converted checkpoint {cfg.exp_name}_{want or '<step>'}.npz under {root} "
            f"(make one with tools/export_torch_params.py)")
    return os.path.join(root, f"{cfg.exp_name}_{want}.npz"), want


def _restore_for_eval(cfg: Config, device: torch.device | str):
    ds, _, test_ids = make_dataset(cfg, device)
    model = make_network(cfg, device)
    path, step = checkpoint_path(cfg)
    model.load_state_dict(load_npz(path))  # strict: topology must match
    model.eval()
    return ds, test_ids, model, step


def _intersect_and_render(cfg: Config, model, o, d, prims, bounds):
    """Interval intersection (the CUDA kernel on a CUDA device), then the
    tiled full-image render."""
    iv = None
    if cfg.render.use_primitives:
        iv = intersect_rays(o, d, prims, cfg.render.near, cfg.render.far,
                            cfg.data.max_intervals)
    return render_image_rays(model, o, d, bounds, cfg, iv=iv)


def _render_view(cfg: Config, model, ds, view: int):
    o, d = view_rays(ds, view)
    prims = view_primitives(ds, view) if cfg.render.use_primitives else None
    bounds = SceneBounds(ds.bounds_center, ds.bounds_scale)
    return _intersect_and_render(cfg, model, o, d, prims, bounds)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_evaluate(cfg: Config, device: torch.device | str, log=print) -> dict:
    """Label-transfer mIoU / PQ on every view with semantic ground truth,
    PSNR (and SSIM, depth errors) on the held-out test views.

    Returns the evaluator summary plus `step` (checkpoint), `views` and
    `render_seconds` (host time per view, render through synchronise).
    """
    ds, test_ids, model, step = _restore_for_eval(cfg, device)
    ev = make_evaluator(cfg)
    has_gt = (ds.gt_sem != 255).flatten(1).any(1).cpu().numpy()
    views = sorted(set(np.nonzero(has_gt)[0].tolist()) | set(int(v) for v in test_ids))
    psnr_views = set(int(v) for v in test_ids)
    hw = tuple(ds.images.shape[1:3])

    seconds = []
    for view in views:
        t0 = time.perf_counter()
        out = _render_view(cfg, model, ds, view)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        gt_rgb = (ds.images[view].reshape(-1, 3).cpu().numpy().astype(np.float32) / 255.0
                  if view in psnr_views else None)
        gt_depth = (ds.depth[view].reshape(-1).cpu().numpy()
                    if view in psnr_views else None)
        ev.evaluate(out, gt_rgb, ds.gt_sem[view].reshape(-1).cpu().numpy(),
                    ds.gt_inst[view].reshape(-1).cpu().numpy(),
                    gt_depth=gt_depth, image_hw=hw)
        log(f"view {view}: rendered in {seconds[-1]:.3f} s")
    res = ev.summarize()
    names = None
    if cfg.model.num_classes == 19:
        from panopticnerf_tpu_torch.data.labels import TRAINID_NAME

        names = TRAINID_NAME
    log(f"evaluate (ckpt step {step}):")
    log(ev.summary_table(names))
    res.update(step=step, views=views, render_seconds=seconds)
    return res
