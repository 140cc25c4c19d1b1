"""Training, evaluation, visualisation and throughput entry points (port of
`panopticnerf_tpu/engine.py`).

`run_train` trains from `init_params` on a device: warm start
(`train.init_from`), resume (`train.resume`), a rotating window of views
streamed from a host-resident pool (`data.stream_window`), the step loop
with one stacked readback of the step's stats every `train.log_interval` steps,
recorder lines, saves every `train.save_ep` epochs and at the end, an
evaluation of the EMA weights every `train.eval_ep` epochs with the
metric-selected checkpoint (`train.save_best`), and a checkpoint at the
next step boundary after SIGTERM. `run_evaluate` restores a checkpoint,
renders every evaluated view (intersection kernel, then the tiled render)
and scores PSNR / mIoU / PQ; `run_visualize` writes images, label maps, a
novel-pose trajectory and a 360-degree panorama; `run_network` times the
training step. Under streaming every render moves the views it touches to
the device.

Each entry point takes a `world` (parallel.maybe_init_distributed: one
process per GPU under torchrun). In a distributed world every rank runs
the steps (`make_parallel_train_step`: the rays split over the ranks) and
every full-image render (its tiles split over the ranks, the maps
gathered on every rank); rank 0 alone logs and writes the recorder, the
checkpoints, the best sidecar, the images and the scores, and the others
wait at a barrier after each save. A SIGTERM to any rank stops every rank
at the same step boundary.

The port's checkpoints live under `<model_dir>/torch/` (`port_roots`).
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
from panopticnerf_tpu_torch.data.stream import (
    HostViews,
    ViewWindowStreamer,
    draw_window,
    views_to,
)
from panopticnerf_tpu_torch.eval import make_evaluator
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.ops.rays import full_image_uv, gen_rays_perspective
from panopticnerf_tpu_torch.parallel import (
    World,
    broadcast_state,
    make_parallel_train_step,
    resolve_world,
)
from panopticnerf_tpu_torch.render import SceneBounds, intersect_and_render, render_panorama
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
    step_path,
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


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _view_on(ds, view: int, dev: torch.device):
    """(dataset, view id) to render `view` on `dev`: `ds` itself where it
    lives on `dev`, else (a streamed pool on the host) that view alone,
    moved to `dev`."""
    if ds.images.device.type == dev.type:
        return ds, view
    return views_to(ds, [view], dev), 0


def _render_view(cfg: Config, model, ds, view: int, world: World | None = None):
    ds, view = _view_on(ds, view, _device_of(model))
    o, d = view_rays(ds, view)
    prims = view_primitives(ds, view) if cfg.render.use_primitives else None
    bounds = SceneBounds(ds.bounds_center, ds.bounds_scale)
    return intersect_and_render(cfg, model, o, d, prims, bounds, world)


def _quiet(*args, **kwargs) -> None:
    """The console of a rank other than 0."""


def _lead_log(world: World, log):
    """Rank 0 owns the console (the JAX engine's `_lead_log`)."""
    return log if world.lead else _quiet


def _make_step(cfg: Config, model, world: World, log):
    """The training step of `world`: the data-parallel step over its ranks
    when distributed (at any size, 1 included), else the single-process one."""
    if not world.distributed:
        return make_train_step(cfg, model)
    step = make_parallel_train_step(cfg, model, world)
    log(f"data-parallel over {world.size} processes ({world.backend}): "
        f"{cfg.data.n_rays // world.size} of {cfg.data.n_rays} rays per rank")
    return step


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
def evaluate_views(cfg: Config, model, ds, view_ids, world: World | None = None) -> dict:
    """Render `view_ids` with `model` and score them (every metric on every
    view): the in-training evaluation. Every rank of a distributed `world`
    renders its tiles and scores the gathered maps, so every rank reads
    the same metrics."""
    ev = make_evaluator(cfg)
    hw = tuple(ds.images.shape[1:3])
    for view in view_ids:
        out = _render_view(cfg, model, ds, int(view), world)
        ev.evaluate(out, image_hw=hw, **_truth(ds, int(view)))
    return ev.summarize()


def run_evaluate(cfg: Config, device: torch.device | str, log=print,
                 world: World | None = None) -> dict | None:
    """Label-transfer mIoU / PQ on every view with semantic ground truth
    (none when the dataset has no ground truth), PSNR (and SSIM, depth
    errors) on the held-out test views.

    Returns the evaluator summary plus `step` (checkpoint), `views` and
    `render_seconds` (host time per view, render through synchronise). In
    a distributed `world` every rank renders its tiles of every view and
    rank 0 scores: the other ranks return None.
    """
    world = resolve_world(cfg, device, world)
    log = _lead_log(world, log)
    device = world.device
    ds, test_ids, model, step = _restore_for_eval(cfg, device)
    ev = make_evaluator(cfg)
    sem_views = []
    if ds.gt_sem is not None:  # a tree without data_2d_semantics has none
        sem_views = np.nonzero((ds.gt_sem != 255).flatten(1).any(1).cpu().numpy())[0].tolist()
    views = sorted(set(sem_views) | set(int(v) for v in test_ids))
    psnr_views = set(int(v) for v in test_ids)
    hw = tuple(ds.images.shape[1:3])

    seconds = []
    for view in views:
        t0 = time.perf_counter()
        out = _render_view(cfg, model, ds, view, world)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        if world.lead:
            ev.evaluate(out, image_hw=hw, **_truth(ds, view, photo=view in psnr_views))
        log(f"view {view}: rendered in {seconds[-1]:.3f} s")
    if not world.lead:
        return None
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


def _stream_windows(cfg: Config, ds, train_ids, test_ids, dev: torch.device, start: int):
    """Streaming's set-up (data.stream_window W > 0, `ds` the host pool):
    -> (streamer, its first window, the window's view ids arange(W), the
    test views on `dev`, their ids renumbered). A run resumed at `start`
    skips the windows an uninterrupted run swapped in before step `start`
    (at steps R, 2R, ... < start, R = data.stream_refresh_steps), so that
    it trains on the same windows; the reference restarts the sequence."""
    host = HostViews(ds, dev)
    skip = (start - 1) // cfg.data.stream_refresh_steps if start > 0 else 0
    streamer = ViewWindowStreamer(host, cfg.data.stream_window, seed=cfg.train.seed,
                                  include=train_ids, skip=skip)
    window, _ = streamer.current()
    return (streamer, window, np.arange(streamer.window_size), host.window(test_ids),
            np.arange(len(test_ids)))


def run_train(cfg: Config, device: torch.device | str, max_steps: int | None = None,
              log=print, world: World | None = None) -> dict:
    """Train for `max_steps` steps (default train.epochs * train.ep_iter),
    from `init_params` (seed train.seed), a warm start or a resumed
    checkpoint; the reference's train_net.py. With data.stream_window > 0
    the steps read a window of the training views resident on the device,
    redrawn every data.stream_refresh_steps, and the in-training
    evaluation reads the test views moved to the device once.

    Returns `state`, `losses` (loss_total of every step this call ran,
    read back once at the end), `stats` (every stat of every step, by name,
    read back with it), `windows` ((steps, seconds) between log
    readbacks, host clock through the readback's synchronisation; saves
    and evaluations fall into the window after them), `metrics` (the last
    log line's stats), `evals` ((step, seconds, summary) of each in-training
    evaluation), `checkpoint` (the last step save), `steps` (the step
    reached), `preempted` and `stream` (None, or when streaming `windows`:
    (first step, pool view ids) of every window this call trained on,
    `blocked` / `ready`: the streamer's seconds waited and copies already
    done at each swap).

    In a distributed `world` every rank trains on its share of each batch
    and returns the same (global) losses and stats; rank 0 writes every
    file (`checkpoint` on the others names the file rank 0 wrote).
    """
    world = resolve_world(cfg, device, world)
    log = _lead_log(world, log)
    dev = world.device
    ds, train_ids, test_ids, model, state = _build(cfg, dev)
    step_fn = _make_step(cfg, model, world, log)
    generator = torch.Generator(dev).manual_seed(cfg.train.seed + 1)
    tc = cfg.train
    total = max_steps if max_steps is not None else tc.epochs * tc.ep_iter
    ckpt_dir, best_dir, best_meta_path, _ = port_roots(cfg)
    step_stats, windows, metrics, evals = [], [], {}, []
    saved, saved_step = None, None

    def save(step: int) -> str:
        """A step checkpoint: rank 0 writes (and prunes), the others wait for it."""
        path = save_model(state, ckpt_dir, step, generator) if world.lead else \
            step_path(ckpt_dir, step)
        if world.distributed:
            world.barrier()
        return path

    streamer, stream_log = None, []

    def result(step: int, was_preempted: bool) -> dict:
        stream = None if streamer is None else {
            "windows": stream_log, "blocked": streamer.blocked, "ready": streamer.ready}
        names = sorted(step_stats[0]) if step_stats else []
        per_step = dict(zip(names, torch.stack([torch.stack([s[k].float() for s in step_stats])
                                                for k in names]).cpu().numpy())) if names else {}
        return {"state": state, "losses": per_step.get("loss_total", np.zeros(0)),
                "stats": per_step,
                "windows": windows, "metrics": metrics, "evals": evals, "checkpoint": saved,
                "steps": step, "preempted": was_preempted, "stream": stream}

    start = 0
    if tc.init_from:
        # partial merge: a narrower pretrained field warm-starts a wider
        # model; unmatched parameters keep their fresh init
        params, init_step = load_network(model.state_dict(), tc.init_from, strict=False)
        model.load_state_dict(params)
        if state.ema is not None:  # an average anchored at the fresh init would drag evals
            state.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        log(f"warm-started params from {tc.init_from} (step {init_step})")
    restored = None
    if tc.resume:  # every rank reads the same file
        _, restored = load_model(state, ckpt_dir, generator=generator)
        if restored is not None:
            start = restored
            log(f"resumed from step {start}")
    if world.distributed:
        broadcast_state(state, generator, world)
    if restored is not None and start >= total:  # nothing to train, and no <total>.pt
        return result(start, False)

    eval_ds = ds
    if cfg.data.stream_window > 0:
        streamer, ds, train_ids, eval_ds, test_ids = _stream_windows(
            cfg, ds, train_ids, test_ids, dev, start)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)

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
    recorder = Recorder(cfg.record_path) if world.lead else None
    try:
        with contextlib.closing(recorder) if recorder is not None else contextlib.nullcontext():
            _sync(dev)
            t0, s0 = time.perf_counter(), start
            for step in range(start, total):
                # a SIGTERM to any rank stops every rank here: one that stopped
                # alone would leave the others blocked in the next collective
                if world.agree(preempted[0]) if world.distributed else preempted[0]:
                    log(f"SIGTERM received: checkpointing at step {step} and exiting")
                    saved = save(step)
                    return result(step, True)
                if streamer is not None:
                    if step > 0 and step % cfg.data.stream_refresh_steps == 0:
                        ds, win = streamer.advance()
                        log(f"stream window refresh #{streamer.refreshes} @step {step}: "
                            f"{len(win)} views [{win.min()}..{win.max()}]")
                    if not stream_log or stream_log[-1][1] is not streamer.current()[1]:
                        stream_log.append((step, streamer.current()[1]))
                stats = step_fn(state, ds, view_ids, generator)
                step_stats.append(stats)
                if (step + 1) % tc.log_interval == 0 or step + 1 == total:
                    names = sorted(stats)  # one readback of every stat
                    vals = torch.stack([stats[k].float() for k in names]).cpu().numpy()
                    dt = time.perf_counter() - t0
                    windows.append((step + 1 - s0, dt))
                    metrics = dict(zip(names, vals.tolist()))
                    metrics["rays_per_sec"] = (step + 1 - s0) * cfg.data.n_rays / dt
                    if recorder is not None:
                        recorder.update(metrics, step=step + 1)
                    log(f"step {step + 1}/{total}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                                zip(names, vals.tolist()))
                        + f", lr {lr_at(cfg, step):.3e}, {metrics['rays_per_sec']:.0f} rays/s, "
                        f"{1000.0 * dt / (step + 1 - s0):.2f} ms/step")
                    t0, s0 = time.perf_counter(), step + 1
                if (step + 1) % tc.record_interval == 0 and recorder is not None:
                    recorder.record("train")
                    log(recorder.log_line((step + 1) // tc.ep_iter, tc.epochs, lr_at(cfg, step)))
                if (step + 1) % (tc.save_ep * tc.ep_iter) == 0 or step + 1 == total:
                    saved, saved_step = save(step + 1), step + 1
                if (step + 1) % (tc.eval_ep * tc.ep_iter) == 0:
                    # one evaluation copy of the network, loaded with the EMA
                    # weights when tracked; the training module is left alone
                    if eval_model is None:
                        eval_model = make_network(cfg, dev).eval()
                    eval_model.load_state_dict(eval_state_dict(state))
                    _sync(dev)
                    te = time.perf_counter()
                    res = evaluate_views(cfg, eval_model, eval_ds, eval_view_ids, world)
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
                        if world.lead:
                            save_model(state, best_dir, step + 1, generator, max_to_keep=1)
                            with open(best_meta_path, "w") as f:
                                json.dump({"value": best_val, "step": step + 1, "metric": kind},
                                          f)
                        if world.distributed:
                            world.barrier()
                        log(f"new best eval metric {best_val:.4f} -> saved best@{step + 1}")
            if saved_step != total:
                saved = save(total)
    finally:
        # restore the caller's handler: a stale one would swallow a later SIGTERM
        signal.signal(signal.SIGTERM, prev_handler)
        if streamer is not None:
            streamer.close()
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


def render_trajectory(cfg: Config, model, ds, n_frames: int, world: World | None = None):
    """Render novel interpolated poses (the reference's demo-video path):
    rays regenerated for each pose, with the intrinsics and the primitive
    table of the nearest training view (the tiles over the ranks of a
    distributed `world`). Yields (frame, nearest view, RenderOut)."""
    h, w = ds.images.shape[1:3]
    dev = _device_of(model)
    uv = full_image_uv(h, w, dev) + 0.5
    for i, (pose, near_view) in enumerate(_trajectory_poses(ds, n_frames)):
        vds, v = _view_on(ds, near_view, dev)
        o, d = gen_rays_perspective(uv, vds.K[v], torch.from_numpy(pose).to(dev))
        prims = view_primitives(vds, v) if cfg.render.use_primitives else None
        bounds = SceneBounds(vds.bounds_center, vds.bounds_scale)
        yield i, near_view, intersect_and_render(cfg, model, o, d, prims, bounds, world)


def run_visualize(cfg: Config, device: torch.device | str, log=print,
                  panorama_hw: tuple | None = None, trajectory: int = 0,
                  world: World | None = None) -> list:
    """Images (rgb, depth, semantic, panoptic) and label maps of every test
    view, then `trajectory` novel-pose frames (ids from 2,000,000), then
    with `panorama_hw` (H, W) one equirect panorama from the middle test
    view (the 360-degree label transfer, id 1,000,000 + view), then videos
    where imageio is present. Returns the files written. In a distributed
    `world` every rank renders its tiles and rank 0 writes: the other ranks
    return an empty list."""
    from panopticnerf_tpu_torch.viz import Visualizer

    world = resolve_world(cfg, device, world)
    log = _lead_log(world, log)
    ds, test_ids, model, _ = _restore_for_eval(cfg, world.device)
    viz = Visualizer(cfg) if world.lead else None
    ev = make_evaluator(cfg)
    hw = tuple(ds.images.shape[1:3])
    written = []

    def write(view_id: int, out, out_hw, label_maps: bool = False) -> None:
        if not world.lead:  # the render is the collective part; the files are rank 0's
            return
        sem, inst = ev.evaluate(out)
        written.extend(viz.write_view(view_id, out, out_hw, sem=sem, inst=inst))
        if label_maps and sem is not None and inst is not None:
            written.extend(viz.write_label_transfer(view_id, sem, inst, out_hw))

    for view in test_ids:
        write(int(view), _render_view(cfg, model, ds, int(view), world), hw, label_maps=True)
    if trajectory > 0:
        for i, _, out in render_trajectory(cfg, model, ds, trajectory, world):
            write(2_000_000 + i, out, hw)
        log(f"trajectory: rendered {trajectory} interpolated poses")
    if panorama_hw is not None:
        view = int(test_ids[len(test_ids) // 2])
        pds, pview = _view_on(ds, view, _device_of(model))
        write(1_000_000 + view, render_panorama(model, pds, pview, panorama_hw, cfg, world),
              tuple(panorama_hw))
    if world.lead:
        for suffix, name in (("_rgb.png", "rgb.mp4"), ("_semantic.png", "semantic.mp4"),
                             ("_panoptic.png", "panoptic.mp4")):
            video = viz.write_video(suffix, name)
            if video:
                written.append(video)
    log(f"wrote {len(written)} files under {cfg.result_path}")
    return written


NETWORK_ITERS = 50  # timed steps of run_network, as the reference's probe


def run_network(cfg: Config, device: torch.device | str, log=print,
                world: World | None = None) -> dict:
    """Throughput probe of the training step (the reference's run.py --type
    network): `train.log_interval` warm-up steps, as many as the median of
    `run_train`'s log windows leaves out (the reference takes one, but a
    step soon after a state is built can stall for 0.1-0.2 s on the card),
    then NETWORK_ITERS steps and one synchronisation. Under streaming the
    steps read the window `run_train` starts with. In a distributed
    `world` the step is the data-parallel one and the rate is the global
    batch's."""
    world = resolve_world(cfg, device, world)
    log = _lead_log(world, log)
    dev = world.device
    ds, train_ids, _, model, state = _build(cfg, dev)
    if cfg.data.stream_window > 0:
        ids = draw_window(np.random.default_rng(cfg.train.seed), train_ids,
                          cfg.data.stream_window)
        ds, train_ids = HostViews(ds, dev).window(ids), np.arange(len(ids))
    step_fn = _make_step(cfg, model, world, log)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
    generator = torch.Generator(dev).manual_seed(0)
    if world.distributed:
        broadcast_state(state, generator, world)
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
