"""Panorama cells: a 360-degree equirect panorama from every view's camera
centre in turn, as a PanopticNeRF-360 labeller exports 360-degree panoptic
labels for every frame of a sequence.

A "view" of this mix is one panorama of the traffic's `hw` (H, W): from view
v's camera centre and orientation, against v's primitive table, through the
program's own `render_panorama` (the equirect rays, kernel A1, then the tiled
coarse and fine evaluation render), with the benchmark's seeded weights; its
rgb, depth and composited semantic logits are read back to the host. The
window is `harness/render.py`'s: one panorama dispatched ahead of the one it
waits for, each panorama's copies to the host enqueued right behind its
kernels, `render_rays_per_s` every ray of every panorama rendered and read
back over the window's wall time (H x W rays a panorama).

The comparison (after the window, with the program's model freed): the
reference's `render_panorama` renders a sample of the window's panoramas,
drawn from the seed, from the same weights and dataset, and the program's
maps are held against it with `harness/render.py`'s `gaps`.

The driver keeps the render driver's contract (`setup`, `sample_views`,
`reference_side`, `gaps`, `run`), so `readings.py` reads it as it reads a
render cell.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from harness import core, trace
from harness.render import gaps, sample_views


def setup(ctx: dict) -> dict:
    """The scene, the dataset and the evaluation model with the seeded
    weights of the configuration's reference (`ref`); `launch(v)` enqueues
    the panorama from view v and the copies of its maps to the host (rgb,
    depth, the composited semantic logits) and returns a handle;
    `fetch(handle)` waits for those copies and returns the maps; `render(v)`
    is the two in one."""
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render import render_panorama

    dev, conf = ctx["device"], ctx["conf"]
    hw = tuple(ctx["traffic"]["hw"])
    cfg, ds, _, build_s = core.build_dataset(conf, ctx["seeds"], ctx["tmpdir"], dev, ctx["sync"])
    ref = core.reference(conf)
    weights = ref.make_weights(conf["program"], ctx["seeds"]["weights"], dev)
    model = make_network(cfg, dev).eval()
    model.load_state_dict(weights)
    fault = ctx.get("fault")
    on_card = torch.device(dev).type == "cuda"

    @torch.no_grad()
    def launch(v: int):
        out = render_panorama(model, ds, v, hw, cfg)
        maps = [out.rgb, out.depth, out.sem_logits]
        if fault == "half_batch":
            maps = [torch.cat([m[: m.shape[0] // 2], torch.zeros_like(m[m.shape[0] // 2:])])
                    for m in maps]
        elif fault == "alter_answer":
            maps[2] = torch.roll(maps[2], 1, dims=-1)
        if not on_card:
            return maps, None
        host = [m.to("cpu", non_blocking=True) for m in maps]  # into pinned memory
        done = torch.cuda.Event()
        done.record()
        return host, done

    def fetch(handle):
        host, done = handle
        if done is not None:
            done.synchronize()
        return host

    return dict(cfg=cfg, ds=ds, build_s=build_s, ref=ref, weights=weights, model=model, hw=hw,
                launch=launch, fetch=fetch, render=lambda v: fetch(launch(v)),
                n_views=ds.images.shape[0], n_rays=hw[0] * hw[1])


def reference_side(conf_program: dict, s: dict, views, quant=None) -> dict:
    """view -> the reference's panorama (rgb, depth, semantic logits) on the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = {k: getattr(s["ds"], k) for k in s["ds"]._fields}
    out = {}
    for v in views:
        r = s["ref"].render_panorama(s["weights"], conf_program, scene, v, s["hw"], quant)
        out[v] = [r["rgb"].cpu(), r["depth"].cpu(), r["sem_logits"].cpu()]
    return out


def run(ctx: dict) -> dict:
    sync, traffic = ctx["sync"], ctx["traffic"]
    s = setup(ctx)
    launch, fetch, n_views = s["launch"], s["fetch"], s["n_views"]
    # the warm-up holds as many panoramas in flight as the window does
    for h in [launch(i % n_views) for i in range(max(2, traffic["warmup_views"]))]:
        fetch(h)
    sync()
    setup_s = time.perf_counter() - ctx["t0"]

    got = {}
    views = 0
    t0 = time.perf_counter()
    marks = []
    pending = launch(0)
    while True:
        ahead = launch((views + 1) % n_views) if time.perf_counter() - t0 < ctx["seconds"] else None
        got[views % n_views] = fetch(pending)
        views += 1
        marks.append(time.perf_counter())
        if ahead is None:
            break
        pending = ahead
    sync()
    window_s = time.perf_counter() - t0
    print(f"set-up {setup_s!r} s (scene and dataset {s['build_s']!r} s); s per panorama: "
          f"{[round(b - a, 4) for a, b in zip([t0] + marks[:-1], marks)]}", file=sys.stderr)
    after_window = core.forbidden_loaded()

    traced, traced_views = None, []
    if ctx["trace"]:
        from torch.profiler import record_function

        def work():
            handles = []
            for i in range(traffic["trace_views"]):
                v = (views + i) % n_views
                traced_views.append(v)
                with record_function("bench.view"):
                    handles.append(launch(v))
                if len(handles) > 1:
                    fetch(handles[-2])
            fetch(handles[-1])
            sync()
            return traffic["trace_views"]

        traced = trace.traced_stretch(work, ctx["tmpdir"], ctx["patterns"],
                                      ctx["required_layers"], sync)

    dev = ctx["device"]
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    del s["model"], s["render"], s["launch"], s["fetch"], launch, fetch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    sample = sample_views(ctx["seeds"]["sample"], got, traffic["check_views"])
    numbers = gaps(got, reference_side(ctx["conf"]["program"], s, sample))

    ds, cfg = s["ds"], s["cfg"]
    p = ds.prim_w2p.shape[1]
    f = ds.prim_planes.shape[2] if ds.prim_planes is not None else 0
    shapes = [dict(n=s["n_rays"], p=p, p_valid=int(ds.prim_valid[v].sum()), f=f,
                   k=cfg.data.max_intervals) for v in traced_views]
    return {
        "e2e": {"render_rays_per_s": views * s["n_rays"] / window_s, "setup_s": setup_s},
        "attempted": views, "failed": 0, "memory_peak_bytes": peak,
        "numbers": numbers, "forbidden": after_window, "trace": traced,
        "layer_ctx": {"cfg": cfg, "n_rays": s["n_rays"], "dataset_build_s": s["build_s"],
                      "a1_shapes": shapes, "window": {"seconds": window_s, "units": views}},
    }
