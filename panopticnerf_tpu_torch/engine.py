"""Training, evaluation, visualisation and throughput entry points (port of
`panopticnerf_tpu/engine.py`).

`run_train` trains from `init_params` on a device: warm start
(`train.init_from`), resume (`train.resume`), the step loop with one
stacked readback of the step's stats every `train.log_interval` steps,
recorder lines, saves every `train.save_ep` epochs and at the end, an
evaluation of the EMA weights every `train.eval_ep` epochs with the
metric-selected checkpoint (`train.save_best`), and a checkpoint at the
next step boundary after SIGTERM. `run_evaluate` restores a checkpoint,
renders every evaluated view (intersection kernel, then the tiled render)
and scores PSNR / mIoU / PQ; `run_visualize` writes images, label maps and
a novel-pose trajectory; `run_network` times the training step.

The port's checkpoints live under `<model_dir>/torch/` (`port_roots`).

Not ported yet (ROADMAP Queue 1): streaming (1.6), the panorama (1.7) and
data parallelism (1.8).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import time
from typing import NamedTuple

import numpy as np
import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
from panopticnerf_tpu_torch.eval import make_evaluator
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.ops.intersect import intersect_rays
from panopticnerf_tpu_torch.ops.rays import full_image_uv, gen_rays_perspective
from panopticnerf_tpu_torch.render import SceneBounds, render_image_rays
from panopticnerf_tpu_torch.train import (
    eval_state_dict,
    lr_at,
    make_train_state,
    make_train_step,
)
from panopticnerf_tpu_torch.train.checkpoint import (
    all_steps,
    latest_step,
    load_model,
    load_network,
    save_model,
)
from panopticnerf_tpu_torch.train.recorder import Recorder


class PortRoots(NamedTuple):
    """Where the port keeps its checkpoints: the reference's layout under
    `<model_dir>`, moved under `<model_dir>/torch/`. The JAX package's
    orbax roots hold nothing of the port's, because orbax scans them for
    step directories, so no port code uses `cfg.trained_model_dir`,
    `cfg.best_model_dir` or `cfg.best_metric_path` bare."""
    steps: str        # torch/<task>/<exp_name>/<step>.pt (train/checkpoint.py)
    best: str         # torch/<task>/<exp_name>_best/<step>.pt, the metric-selected one
    best_metric: str  # torch/<task>/<exp_name>_best_metric.json {value, step, metric}
    converted: str    # torch/, holding weights-only <exp_name>_<step>.npz
    #                   (tools/export_torch_params.py)


def port_roots(cfg: Config) -> PortRoots:
    base = os.path.join(cfg.model_dir, "torch")
    under = lambda path: os.path.join(base, os.path.relpath(path, cfg.model_dir))
    return PortRoots(under(cfg.trained_model_dir), under(cfg.best_model_dir),
                     under(cfg.best_metric_path), base)


def checkpoint_path(cfg: Config) -> tuple[str, int]:
    """Where an evaluation reads its weights -> (a step root or a converted
    `.npz`, step). train.eval_step -1: the best root's step; otherwise step
    train.eval_step (0 = the latest) of the step root, or of the converted
    `<model_dir>/torch/<exp_name>_<step>.npz` files."""
    roots = port_roots(cfg)
    if cfg.train.eval_step == -1:
        step = latest_step(roots.best)
        if step is None:
            raise FileNotFoundError(f"no best checkpoint under {roots.best} (train.save_best)")
        return roots.best, step
    root, npz_dir = roots.steps, roots.converted
    pat = re.compile(re.escape(cfg.exp_name) + r"_(\d+)\.npz")
    npz = {int(m.group(1)): os.path.join(npz_dir, f)
           for f in (os.listdir(npz_dir) if os.path.isdir(npz_dir) else [])
           if (m := pat.fullmatch(f))}
    steps = all_steps(root)
    want = cfg.train.eval_step or max(steps + list(npz), default=None)
    if want in steps:
        return root, want
    if want in npz:
        return npz[want], want
    raise FileNotFoundError(
        f"no checkpoint of step {want or '<latest>'} under {root}, nor a converted "
        f"{cfg.exp_name}_{want or '<step>'}.npz under {npz_dir} "
        f"(train one, or convert one with tools/export_torch_params.py)")


def _restore_for_eval(cfg: Config, device: torch.device | str):
    ds, _, test_ids = make_dataset(cfg, device)
    model = make_network(cfg, device)
    path, step = checkpoint_path(cfg)
    params, _ = load_network(model.state_dict(), path, step,  # strict: topology must match
                             prefer_ema=cfg.train.ema_decay > 0)
    model.load_state_dict(params)
    model.eval()
    return ds, test_ids, model, step


def _intersect_and_render(cfg: Config, model, o, d, prims, bounds):
    """Interval intersection (the CUDA kernel on a CUDA device), then the
    tiled full-image render. Every full-image render goes through here:
    evaluated views and trajectory frames."""
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


def _truth(ds, view: int, photo: bool = True) -> dict:
    """The evaluator's ground truth of one view as flat host arrays: labels
    and the valid mask always, rgb and depth when `photo`."""
    flat = lambda t: t[view].reshape(-1).cpu().numpy() if t is not None else None
    return dict(
        gt_rgb=(ds.images[view].reshape(-1, 3).cpu().numpy().astype(np.float32) / 255.0
                if photo else None),
        gt_sem=flat(ds.gt_sem), gt_inst=flat(ds.gt_inst), valid=flat(ds.valid_mask),
        gt_depth=flat(ds.depth) if photo else None)


@torch.no_grad()
def evaluate_views(cfg: Config, model, ds, view_ids) -> dict:
    """Render `view_ids` with `model` and score them (every metric on every
    view): the in-training evaluation."""
    ev = make_evaluator(cfg)
    hw = tuple(ds.images.shape[1:3])
    for view in view_ids:
        out = _render_view(cfg, model, ds, int(view))
        ev.evaluate(out, image_hw=hw, **_truth(ds, int(view)))
    return ev.summarize()


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
        ev.evaluate(out, image_hw=hw, **_truth(ds, view, photo=view in psnr_views))
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


def _build(cfg: Config, dev: torch.device):
    ds, train_ids, test_ids = make_dataset(cfg, dev)
    model = make_network(cfg, dev)
    init_params(model, torch.Generator(dev).manual_seed(cfg.train.seed))
    return ds, train_ids, test_ids, model, make_train_state(cfg, model)


def _selection_metric(res: dict):
    """save_best's metric: (mIoU + PQ) / 2 when instances are scored, else
    mIoU, else PSNR -> (value | None, kind)."""
    if "miou" in res and "pq" in res:
        return 0.5 * (float(res["miou"]) + float(res["pq"])), "miou_pq_mean"
    if "miou" in res:
        return float(res["miou"]), "miou"
    return res.get("psnr"), "psnr"


def run_train(cfg: Config, device: torch.device | str, max_steps: int | None = None,
              log=print) -> dict:
    """Train for `max_steps` steps (default train.epochs * train.ep_iter),
    from `init_params` (seed train.seed), a warm start or a resumed
    checkpoint; the reference's train_net.py.

    Returns `state`, `losses` (loss_total of every step this call ran,
    read back once at the end), `windows` ((steps, seconds) between log
    readbacks, host clock through the readback's synchronisation; saves
    and evaluations fall into the window after them), `metrics` (the last
    log line's stats), `evals` ((step, seconds, summary) of each in-training
    evaluation), `checkpoint` (the last step save), `steps` (the step
    reached) and `preempted`.
    """
    dev = torch.device(device)
    ds, train_ids, test_ids, model, state = _build(cfg, dev)
    step_fn = make_train_step(cfg, model)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
    generator = torch.Generator(dev).manual_seed(cfg.train.seed + 1)
    tc = cfg.train
    total = max_steps if max_steps is not None else tc.epochs * tc.ep_iter
    ckpt_dir, best_dir, best_meta_path, _ = port_roots(cfg)
    losses, windows, metrics, evals = [], [], {}, []
    saved, saved_step = None, None

    def result(step: int, was_preempted: bool) -> dict:
        return {"state": state,
                "losses": torch.stack(losses).cpu().numpy() if losses else np.zeros(0),
                "windows": windows, "metrics": metrics, "evals": evals, "checkpoint": saved,
                "steps": step, "preempted": was_preempted}

    start = 0
    if tc.init_from:
        # partial merge: a narrower pretrained field warm-starts a wider
        # model; unmatched parameters keep their fresh init
        params, init_step = load_network(model.state_dict(), tc.init_from, strict=False)
        model.load_state_dict(params)
        if state.ema is not None:  # an average anchored at the fresh init would drag evals
            state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        log(f"warm-started params from {tc.init_from} (step {init_step})")
    if tc.resume:
        _, restored = load_model(state, ckpt_dir, generator=generator)
        if restored is not None:
            start = restored
            log(f"resumed from step {start}")
            if start >= total:  # nothing to train, and no <total>.pt holding a later step
                return result(start, False)

    # The best value survives preemption through the sidecar: otherwise the
    # first evaluation after a resume (> -inf) would replace the true best.
    best_val, best_kind = -np.inf, None
    if tc.resume and os.path.exists(best_meta_path):
        with open(best_meta_path) as f:
            meta = json.load(f)
        best_val = float(meta["value"])
        # a sidecar without a metric name was written by single-metric
        # (mIoU or PSNR) selection, never by the (mIoU + PQ) / 2 mean
        best_kind = meta.get("metric", "legacy")
        log(f"best-metric state restored: {best_val:.4f} ({best_kind})")

    eval_view_ids = test_ids if tc.eval_views <= 0 else test_ids[:tc.eval_views]
    eval_model = None
    preempted = [False]

    def _on_term(signum, frame):
        preempted[0] = True

    prev_handler = signal.signal(signal.SIGTERM, _on_term)
    try:
        with contextlib.closing(Recorder(cfg.record_path)) as recorder:
            _sync(dev)
            t0, s0 = time.perf_counter(), start
            for step in range(start, total):
                if preempted[0]:
                    log(f"SIGTERM received: checkpointing at step {step} and exiting")
                    saved = save_model(state, ckpt_dir, step, generator)
                    return result(step, True)
                stats = step_fn(state, ds, view_ids, generator)
                losses.append(stats["loss_total"])
                if (step + 1) % tc.log_interval == 0 or step + 1 == total:
                    names = sorted(stats)  # one readback of every stat
                    vals = torch.stack([stats[k].float() for k in names]).cpu().numpy()
                    dt = time.perf_counter() - t0
                    windows.append((step + 1 - s0, dt))
                    metrics = dict(zip(names, vals.tolist()))
                    metrics["rays_per_sec"] = (step + 1 - s0) * cfg.data.n_rays / dt
                    recorder.update(metrics, step=step + 1)
                    log(f"step {step + 1}/{total}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                                zip(names, vals.tolist()))
                        + f", lr {lr_at(cfg, step):.3e}, {metrics['rays_per_sec']:.0f} rays/s, "
                        f"{1000.0 * dt / (step + 1 - s0):.2f} ms/step")
                    t0, s0 = time.perf_counter(), step + 1
                if (step + 1) % tc.record_interval == 0:
                    recorder.record("train")
                    log(recorder.log_line((step + 1) // tc.ep_iter, tc.epochs, lr_at(cfg, step)))
                if (step + 1) % (tc.save_ep * tc.ep_iter) == 0 or step + 1 == total:
                    saved, saved_step = save_model(state, ckpt_dir, step + 1, generator), step + 1
                if (step + 1) % (tc.eval_ep * tc.ep_iter) == 0:
                    # one evaluation copy of the network, loaded with the EMA
                    # weights when tracked; the training module is left alone
                    if eval_model is None:
                        eval_model = make_network(cfg, dev).eval()
                    eval_model.load_state_dict(eval_state_dict(state))
                    _sync(dev)
                    te = time.perf_counter()
                    res = evaluate_views(cfg, eval_model, ds, eval_view_ids)
                    evals.append((step + 1, time.perf_counter() - te, res))
                    log(f"eval@{step + 1}: " + ", ".join(
                        f"{k}={v:.3f}" for k, v in res.items() if np.isscalar(v)))
                    val, kind = _selection_metric(res)
                    if best_kind == "legacy" and kind != "miou_pq_mean":
                        # single-metric values stay comparable; against the mean
                        # an old mIoU-only value would win forever (PQ <= mIoU),
                        # so that case resets below
                        best_kind = kind
                    if best_kind is not None and kind != best_kind:
                        log(f"best-metric sidecar used {best_kind!r}, this run selects on "
                            f"{kind!r} — resetting best state")
                        best_val = -np.inf
                    best_kind = kind
                    if tc.save_best and val is not None and float(val) > best_val:
                        best_val = float(val)
                        save_model(state, best_dir, step + 1, generator, max_to_keep=1)
                        with open(best_meta_path, "w") as f:
                            json.dump({"value": best_val, "step": step + 1, "metric": kind}, f)
                        log(f"new best eval metric {best_val:.4f} -> saved best@{step + 1}")
            if saved_step != total:
                saved = save_model(state, ckpt_dir, total, generator)
    finally:
        # restore the caller's handler: a stale one would swallow a later SIGTERM
        signal.signal(signal.SIGTERM, prev_handler)
    return result(total, False)


def _trajectory_poses(ds, n_frames: int):
    """A smooth camera path through the perspective training poses:
    translation lerp, rotation chord-lerp re-orthonormalised by SVD (slerp
    for the small angles between frames of a driving sequence).
    Returns [(c2w (3, 4) float32, nearest view id), ...]."""
    c2w = ds.c2w.detach().cpu().numpy().astype(np.float64)
    ids = np.arange(c2w.shape[0])
    if ds.cam_model is not None:  # pinhole views only (fisheye poses jump)
        keep = ds.cam_model.cpu().numpy() == 0
        c2w, ids = c2w[keep], ids[keep]
    if c2w.shape[0] < 2:
        raise ValueError("trajectory rendering needs >= 2 perspective views")
    out = []
    for t in np.linspace(0.0, c2w.shape[0] - 1.0, n_frames):
        i = min(int(np.floor(t)), c2w.shape[0] - 2)
        a = t - i
        R = (1 - a) * c2w[i, :, :3] + a * c2w[i + 1, :, :3]
        u, _, vt = np.linalg.svd(R)
        R = u @ vt
        if np.linalg.det(R) < 0:
            R = u @ np.diag([1.0, 1.0, -1.0]) @ vt
        tr = (1 - a) * c2w[i, :, 3] + a * c2w[i + 1, :, 3]
        pose = np.concatenate([R, tr[:, None]], axis=1).astype(np.float32)
        out.append((pose, int(ids[int(round(t))])))
    return out


def render_trajectory(cfg: Config, model, ds, n_frames: int):
    """Render novel interpolated poses (the reference's demo-video path):
    rays regenerated for each pose, with the intrinsics and the primitive
    table of the nearest training view. Yields (frame, nearest view,
    RenderOut)."""
    h, w = ds.images.shape[1:3]
    dev = ds.images.device
    uv = full_image_uv(h, w, dev) + 0.5
    bounds = SceneBounds(ds.bounds_center, ds.bounds_scale)
    for i, (pose, near_view) in enumerate(_trajectory_poses(ds, n_frames)):
        o, d = gen_rays_perspective(uv, ds.K[near_view], torch.from_numpy(pose).to(dev))
        prims = view_primitives(ds, near_view) if cfg.render.use_primitives else None
        yield i, near_view, _intersect_and_render(cfg, model, o, d, prims, bounds)


def run_visualize(cfg: Config, device: torch.device | str, log=print,
                  panorama_hw: tuple | None = None, trajectory: int = 0) -> list:
    """Images (rgb, depth, semantic, panoptic) and label maps of every test
    view, then `trajectory` novel-pose frames (ids from 2,000,000), then
    videos where imageio is present. Returns the files written."""
    if panorama_hw is not None:
        raise NotImplementedError(
            "--panorama (render_panorama, 360-degree label transfer) is not ported yet: "
            "ROADMAP 1.7")
    from panopticnerf_tpu_torch.viz import Visualizer

    ds, test_ids, model, _ = _restore_for_eval(cfg, device)
    viz = Visualizer(cfg)
    ev = make_evaluator(cfg)
    hw = tuple(ds.images.shape[1:3])
    written = []
    for view in test_ids:
        out = _render_view(cfg, model, ds, int(view))
        sem, inst = ev.evaluate(out)
        written += viz.write_view(int(view), out, hw, sem=sem, inst=inst)
        if sem is not None and inst is not None:
            written += viz.write_label_transfer(int(view), sem, inst, hw)
    if trajectory > 0:
        for i, _, out in render_trajectory(cfg, model, ds, trajectory):
            sem_t, inst_t = ev.evaluate(out)
            written += viz.write_view(2_000_000 + i, out, hw, sem=sem_t, inst=inst_t)
        log(f"trajectory: rendered {trajectory} interpolated poses")
    for suffix, name in (("_rgb.png", "rgb.mp4"), ("_semantic.png", "semantic.mp4"),
                         ("_panoptic.png", "panoptic.mp4")):
        video = viz.write_video(suffix, name)
        if video:
            written.append(video)
    log(f"wrote {len(written)} files under {cfg.result_path}")
    return written


NETWORK_ITERS = 50  # timed steps of run_network, as the reference's probe


def run_network(cfg: Config, device: torch.device | str, log=print) -> dict:
    """Throughput probe of the training step (the reference's run.py --type
    network): `train.log_interval` warm-up steps, as many as the median of
    `run_train`'s log windows leaves out (the reference takes one, but a
    step soon after a state is built can stall for 0.1-0.2 s on the card),
    then NETWORK_ITERS steps and one synchronisation."""
    dev = torch.device(device)
    ds, train_ids, _, model, state = _build(cfg, dev)
    step_fn = make_train_step(cfg, model)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
    generator = torch.Generator(dev).manual_seed(0)
    for _ in range(max(cfg.train.log_interval, 1)):
        stats = step_fn(state, ds, view_ids, generator)
    float(stats["loss_total"])  # the warm-up's end
    t0 = time.perf_counter()
    for _ in range(NETWORK_ITERS):
        stats = step_fn(state, ds, view_ids, generator)
    float(stats["loss_total"])  # the one synchronisation
    dt = time.perf_counter() - t0
    rays_per_sec = cfg.data.n_rays * NETWORK_ITERS / dt
    log(f"train-step throughput: {NETWORK_ITERS} iters in {dt:.2f}s -> "
        f"{rays_per_sec:,.0f} rays/s ({NETWORK_ITERS / dt:.1f} it/s)")
    return {"rays_per_sec": rays_per_sec, "iters_per_sec": NETWORK_ITERS / dt}
