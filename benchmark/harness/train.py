"""Training cells: the program's training step, driven as `engine.run_train`
drives it in one process.

Set-up builds the scene, the program's dataset, the model with the
benchmark's seeded weights and one train state, and drives that state
through its first steps with the window's own call and feed: each step is
`make_train_step(cfg, model)(state, ds, view_ids, draws=...)` on a fresh
batch drawn by the benchmark from the seed, and every `train.log_interval`
steps the step's stats are read back once, as the engine reads them. The
first `check_steps` steps are kept for the comparison; warm-up continues
on the same state, and the window then runs for `--seconds`.

`train_rays_per_s` is every ray of every step of the window over the
window's wall time; the window ends at a readback, so every step counted
has finished on the device.

The comparison (after the window, with the program's state freed): the
reference trains the same initial weights on the same draws for the same
steps; compared are each step's loss, the first gradient (from Adam's
first moment after step 1) and the parameters' change after the kept
steps, both by their worst leaf.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from harness import core, trace

ADAM_B1 = 0.9


def _draws(g, cfg, n_views: int, hw, device):
    """One step's random numbers, in the calls and shapes the program's own
    draw_step makes them: the batch's groups and pixels, the guided
    coarse and background jitter, the inverse-CDF jitter."""
    from panopticnerf_tpu_torch.ops.sampling import guided_split

    n, gr = cfg.data.n_rays, cfg.data.views_per_batch
    h, w = hw
    rc = cfg.render
    s_in, s_bg = guided_split(rc.n_samples, rc.bg_sample_frac)
    ri = lambda hi, size: torch.randint(0, hi, (size,), generator=g, device=device)
    r = lambda *shape: torch.rand(shape, generator=g, device=device)
    return dict(group=ri(n_views, gr), u=ri(w, n), v=ri(h, n), coarse=r(n, s_in),
                bg=r(n, s_bg) if s_bg > 0 else None, fine=r(n, rc.n_importance))


def _as_program(d: dict):
    from panopticnerf_tpu_torch.data.dataset import BatchDraws
    from panopticnerf_tpu_torch.render.renderer import RenderDraws
    from panopticnerf_tpu_torch.train.step import StepDraws

    return StepDraws(BatchDraws(d["group"], d["u"], d["v"]),
                     RenderDraws(d["coarse"], d["bg"], d["fine"], None, None))


def _half(d: dict, cfg) -> dict:
    """The first half of a batch's rays (its first G / 2 groups)."""
    n, g = cfg.data.n_rays // 2, cfg.data.views_per_batch // 2
    return {k: None if v is None else (v[:g] if k == "group" else v[:n]) for k, v in d.items()}


def setup(ctx: dict) -> dict:
    """The scene, the dataset, the model with the seeded weights of the
    configuration's reference (`ref`, which trains the comparison too), one
    train state and its step; then the first `check_steps` steps through
    the window's call and feed, with what the comparison keeps of them."""
    import dataclasses

    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.train.step import make_train_state, make_train_step

    dev, seeds, traffic = ctx["device"], ctx["seeds"], ctx["traffic"]
    conf = ctx["conf"]
    cfg, ds, train_ids, build_s = core.build_dataset(conf, seeds, ctx["tmpdir"], dev, ctx["sync"])
    ref = core.reference(conf)
    weights = ref.make_weights(conf["program"], seeds["weights"], dev)
    model = make_network(cfg, dev)
    model.load_state_dict(weights)
    state = make_train_state(cfg, model)
    start = (cfg.train.pretrain_steps if traffic["start"] == "semantic_on"
             and cfg.train.pretrain == "nerf" else 0)
    state.step = start
    step = make_train_step(cfg, model)
    fault = ctx.get("fault")
    if fault == "half_batch":
        half_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, n_rays=cfg.data.n_rays // 2, views_per_batch=cfg.data.views_per_batch // 2))
        half_step = make_train_step(half_cfg, model)
        step = lambda st, d, v, draws, _c=cfg: half_step(st, d, v, draws=_as_program(_half(draws, _c)))
    else:
        inner = step
        step = lambda st, d, v, draws: inner(st, d, v, draws=_as_program(draws))
    if fault == "state_unchanged":
        inner_u = step

        def step(st, d, v, draws):
            keep = [p.detach().clone() for p in st.model.parameters()]
            out = inner_u(st, d, v, draws)
            with torch.no_grad():
                for p, k in zip(st.model.parameters(), keep):
                    p.copy_(k)
            return out

    view_ids = torch.as_tensor(train_ids, device=dev)
    gen = torch.Generator(dev).manual_seed(seeds["draws"])
    hw = tuple(ds.images.shape[1:3])
    names_of = {p: n for n, p in model.named_parameters()}
    s = dict(cfg=cfg, ds=ds, build_s=build_s, ref=ref, weights=weights, model=model, state=state,
             start=start, view_ids=view_ids,
             draw=lambda: _draws(gen, cfg, len(train_ids), hw, dev),
             one=lambda d: step(state, ds, view_ids, d))
    kept, losses = [], []
    for i in range(traffic["check_steps"]):
        d = s["draw"]()
        stats = s["one"](d)
        kept.append(d)
        losses.append(float(stats["loss_total"]))
        if i == 0:
            grads1 = {names_of[p]: st["exp_avg"].detach().clone() / (1 - ADAM_B1)
                      for p, st in state.optimizer.state.items()}
    delta = {n: (p.detach() - weights[n]).clone() for n, p in model.named_parameters()}
    s.update(kept=kept, side={"losses": losses, "grads1": grads1, "delta": delta})
    return s


def reference_side(conf_program: dict, s: dict, quant=None, n_rays=None) -> dict:
    """The reference over the kept steps from the same weights and draws:
    `quant` computes it in a lower precision (the control), `n_rays` on
    the batches' first rays only (the half-batch fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = {k: getattr(s["ds"], k) for k in s["ds"]._fields}
    trainer = s["ref"].Trainer(conf_program, s["weights"], s["start"], quant)
    losses = [trainer.step(scene, s["view_ids"], d, n_rays) for d in s["kept"]]
    delta = {k: trainer.params[k].detach() - w for k, w in s["weights"].items()}
    return {"losses": losses, "grads1": trainer.first_grads, "delta": delta}


def gaps(ref, side: dict, ref_side: dict) -> tuple[dict, str]:
    """The numbers compared -> ({loss_gap, grad_gap, change_gap}, a note):
    each step's loss (relative), the first gradient's and the change's
    norms by their worst leaf; leaves whose reference gradient is nought
    to rounding (under a thousandth of the median leaf's) are left out of
    the change, by `ref`'s (the reference module's) `quiet_leaves`."""
    quiet = ref.quiet_leaves(ref_side["grads1"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(side["losses"], ref_side["losses"]))
    grad_gap, grad_leaf = ref.leaf_gap(side["grads1"], ref_side["grads1"])
    change_gap, change_leaf = ref.leaf_gap(side["delta"], ref_side["delta"],
                                           keep=set(ref_side["delta"]) - quiet)
    note = (f"losses {side['losses']} reference {ref_side['losses']}; worst gradient leaf "
            f"{grad_leaf}, worst change leaf {change_leaf}; quiet leaves left out: {sorted(quiet)}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}, note


def run(ctx: dict) -> dict:
    sync, traffic = ctx["sync"], ctx["traffic"]
    s = setup(ctx)
    cfg, one, draw = s["cfg"], s["one"], s["draw"]
    log_every = cfg.train.log_interval

    def readback(stats):
        return torch.stack([stats[k].float() for k in sorted(stats)]).cpu()

    done = traffic["check_steps"]
    while done < traffic["warmup_steps"] or done % log_every:
        stats = one(draw())
        done += 1
        if done % log_every == 0:
            readback(stats)
    sync()
    setup_s = time.perf_counter() - ctx["t0"]

    # the window
    steps = 0
    marks, cpu = [], []
    t0, c0 = time.perf_counter(), time.thread_time()
    while True:
        stats = one(draw())
        steps += 1
        if steps % log_every == 0:
            readback(stats)
            marks.append(time.perf_counter())
            cpu.append(time.thread_time())
            if marks[-1] - t0 >= ctx["seconds"]:
                break
    sync()
    window_s = time.perf_counter() - t0
    ms = [1e3 * (b - a) / log_every for a, b in zip([t0] + marks[:-1], marks)]
    busy = [(d - c) / (b - a) for a, b, c, d in zip([t0] + marks[:-1], marks, [c0] + cpu[:-1], cpu)]
    print(f"set-up {setup_s!r} s (scene and dataset {s['build_s']!r} s); ms/step per "
          f"readback interval: {[round(x, 3) for x in ms]}; the main thread's CPU time over "
          f"the wall time there: {[round(x, 3) for x in busy]}", file=sys.stderr)
    after_window = core.forbidden_loaded()

    traced = None
    if ctx["trace"]:
        from torch.profiler import record_function

        def work():
            for i in range(traffic["trace_steps"]):
                with record_function("bench.draws"):
                    d = draw()
                with record_function("bench.step"):
                    st = one(d)
                if (i + 1) % log_every == 0:
                    with record_function("bench.readback"):
                        readback(st)
            sync()
            return traffic["trace_steps"]

        traced = trace.traced_stretch(work, ctx["tmpdir"], ctx["patterns"],
                                      ctx["required_layers"], sync)

    dev = ctx["device"]
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    for k in ("model", "state", "one"):
        del s[k]
    del stats, one
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    numbers, note = gaps(s["ref"], s["side"], reference_side(ctx["conf"]["program"], s))
    print(note, file=sys.stderr)
    return {
        "e2e": {"train_rays_per_s": steps * cfg.data.n_rays / window_s, "setup_s": setup_s},
        "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
        "numbers": numbers, "forbidden": after_window, "trace": traced,
        "layer_ctx": {"cfg": cfg, "n_rays": cfg.data.n_rays, "dataset_build_s": s["build_s"],
                      "window": {"seconds": window_s, "units": steps}},
    }
