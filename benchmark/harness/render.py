"""Render cells: the label-transfer render of every view in turn.

Each view goes through the program's `intersect_and_render` (kernel A1,
then the tiled coarse and fine evaluation render) with the benchmark's
seeded weights, and its rgb, depth and learned semantic labels are read
back to the host, as the export needs them. The window keeps one view
dispatched ahead of the one it waits for: view v+1 is enqueued before view
v's maps are awaited, and each view's copies to the host are enqueued right
behind its own kernels, so the device is not left idle while the host reads
back one view and enqueues the next. `render_rays_per_s` is every ray of
every view rendered and read back in the window over the window's wall
time: once the time is up nothing more is sent, the view in flight is
awaited and counted, and the clock is read after that wait.

The comparison (after the window, with the program's model freed): the
reference renders a sample of the window's views, drawn from the seed,
from the same weights and dataset, and the program's maps of those views
are held against it.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import core, trace


def setup(ctx: dict) -> dict:
    """The scene, the dataset and the evaluation model with the seeded
    weights of the configuration's reference (`ref`, which renders the
    comparison too); `launch(v)` enqueues view v's render and the copies of
    its maps to the host (rgb, depth and the composited semantic logits,
    which the export's panoptic fusion turns into labels) and returns a
    handle; `fetch(handle)` waits for those copies and returns the maps;
    `render(v)` is the two in one."""
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render.renderer import SceneBounds, intersect_and_render

    dev, conf = ctx["device"], ctx["conf"]
    cfg, ds, _, build_s = core.build_dataset(conf, ctx["seeds"], ctx["tmpdir"], dev, ctx["sync"])
    ref = core.reference(conf)
    weights = ref.make_weights(conf["program"], ctx["seeds"]["weights"], dev)
    model = make_network(cfg, dev).eval()
    model.load_state_dict(weights)
    bounds = SceneBounds(ds.bounds_center, ds.bounds_scale)
    fault = ctx.get("fault")

    on_card = torch.device(dev).type == "cuda"

    @torch.no_grad()
    def launch(v: int):
        o, d = view_rays(ds, v)
        out = intersect_and_render(cfg, model, o, d, view_primitives(ds, v), bounds)
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

    return dict(cfg=cfg, ds=ds, build_s=build_s, ref=ref, weights=weights, model=model,
                launch=launch, fetch=fetch, render=lambda v: fetch(launch(v)),
                n_views=ds.images.shape[0],
                n_rays=int(ds.images.shape[1] * ds.images.shape[2]))


def sample_views(seed: int, views, count: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(sorted(views), size=min(count, len(views)), replace=False).tolist())


def reference_side(conf_program: dict, s: dict, views, quant=None) -> dict:
    """view -> the reference's (rgb, depth, semantic logits) on the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = {k: getattr(s["ds"], k) for k in s["ds"]._fields}
    out = {}
    for v in views:
        r = s["ref"].render_view(s["weights"], conf_program, scene, v, quant)
        out[v] = [r["rgb"].cpu(), r["depth"].cpu(), r["sem_logits"].cpu()]
    return out


def gaps(got: dict, ref_maps: dict) -> dict:
    """Worst view of: the mean absolute rgb gap; the mean absolute depth
    gap and the semantic logits' mean absolute gap, each over the
    reference's mean absolute value."""
    numbers = {"rgb_gap": 0.0, "depth_gap": 0.0, "sem_gap": 0.0}
    for v, (rr, rd, rs) in ref_maps.items():
        rgb, depth, sem = got[v]
        numbers["rgb_gap"] = max(numbers["rgb_gap"], float((rgb - rr).abs().mean()))
        numbers["depth_gap"] = max(numbers["depth_gap"], float(
            (depth - rd).abs().mean() / rd.abs().mean().clamp(min=1e-30)))
        numbers["sem_gap"] = max(numbers["sem_gap"], float(
            (sem - rs).abs().mean() / rs.abs().mean().clamp(min=1e-30)))
    return numbers


def run(ctx: dict) -> dict:
    sync, traffic = ctx["sync"], ctx["traffic"]
    s = setup(ctx)
    launch, fetch, n_views = s["launch"], s["fetch"], s["n_views"]
    # the warm-up holds as many views in flight as the window does
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
    print(f"set-up {setup_s!r} s (scene and dataset {s['build_s']!r} s); s per view: "
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
