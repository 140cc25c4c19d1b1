"""Training and evaluation entry points (port of `panopticnerf_tpu/engine.py`).

`run_train` trains from `init_params` on a device: the step loop with one
stacked readback of the step's stats every `train.log_interval` steps, and
at the end the params as `<model_dir>/torch/<exp_name>_<step>.npz`.
`run_evaluate` builds the dataset on a device, restores such a checkpoint,
renders every evaluated view (intersection kernel, then the tiled render)
and scores PSNR / mIoU / PQ.

Not ported yet (ROADMAP Queue 1.4 / 1.6): resume, warm start
(`train.init_from`), the in-training evaluation cadence and save_best, the
SIGTERM checkpoint, the recorder, streaming, visualisation and the
throughput probe.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.convert import load_npz, save_npz
from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
from panopticnerf_tpu_torch.eval import make_evaluator
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.ops.intersect import intersect_rays
from panopticnerf_tpu_torch.render import SceneBounds, render_image_rays
from panopticnerf_tpu_torch.train import (
    eval_state_dict,
    lr_at,
    make_train_state,
    make_train_step,
)


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


def run_train(cfg: Config, device: torch.device | str, max_steps: int | None = None,
              log=print) -> dict:
    """Train from `init_params` (seed train.seed) for `max_steps` steps
    (default train.epochs * train.ep_iter), then write the params (the EMA
    when tracked) to `<model_dir>/torch/<exp_name>_<steps>.npz`.

    Returns `state`, `losses` (every step's loss_total, read back once at
    the end), `windows` ((steps, seconds) between log readbacks, host clock
    through the readback's synchronisation), `metrics` (the last log
    line's stats), `checkpoint` and `steps`.
    """
    dev = torch.device(device)
    ds, train_ids, _ = make_dataset(cfg, dev)
    model = make_network(cfg, dev)
    init_params(model, torch.Generator(dev).manual_seed(cfg.train.seed))
    state = make_train_state(cfg, model)
    step_fn = make_train_step(cfg, model)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
    generator = torch.Generator(dev).manual_seed(cfg.train.seed + 1)
    tc = cfg.train
    total = max_steps if max_steps is not None else tc.epochs * tc.ep_iter

    losses, windows, metrics = [], [], {}
    _sync(dev)
    t0, s0 = time.perf_counter(), 0
    for step in range(total):
        stats = step_fn(state, ds, view_ids, generator)
        losses.append(stats["loss_total"])
        if (step + 1) % tc.log_interval == 0 or step + 1 == total:
            names = sorted(stats)
            vals = torch.stack([stats[k].float() for k in names]).cpu().numpy()  # one readback
            dt = time.perf_counter() - t0
            windows.append((step + 1 - s0, dt))
            metrics = dict(zip(names, vals.tolist()))
            metrics["rays_per_sec"] = (step + 1 - s0) * cfg.data.n_rays / dt
            log(f"step {step + 1}/{total}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                        zip(names, vals.tolist()))
                + f", lr {lr_at(cfg, step):.3e}, {metrics['rays_per_sec']:.0f} rays/s, "
                f"{1000.0 * dt / (step + 1 - s0):.2f} ms/step")
            t0, s0 = time.perf_counter(), step + 1
    root = os.path.join(cfg.model_dir, "torch")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{cfg.exp_name}_{total}.npz")
    save_npz(path, eval_state_dict(state))
    log(f"wrote {path}")
    return {"state": state, "losses": torch.stack(losses).cpu().numpy() if losses else np.zeros(0),
            "windows": windows, "metrics": metrics, "checkpoint": path, "steps": total}
