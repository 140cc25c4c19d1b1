#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, runs the port's evaluation of the
committed flagship checkpoint against the JAX package's recorded scores,
replays one recorded JAX training step, and trains the flagship for 200
steps through the kernels.

    python3 chip_smoke.py          # from the repo root, on a machine with one NVIDIA GPU

Phases (any failure raises; the exit code is then non-zero and no result
line is printed):
  1. card, power limit, torch / CUDA / nvcc versions;
  2. build of csrc/intersect.cu and csrc/mlp_train.cu, one nvcc each, run
     together (timed; ptxas registers / shared memory / spills);
  3. kernel vs plain version on every synthetic_flagship view
     (N = 33,088 rays, P = 32, K = 16, F = 0) and on a cut-plane case
     (F = 8 seeded half-spaces through each box centre): share of
     (ray, slot) entries that differ, max |dt| where they agree;
  4. median kernel and plain times at the view shape (CUDA events);
  5. the main path: `engine.run_evaluate` on configs/synthetic_flagship.yaml
     with artifacts/torch/synthetic_flagship_10000.npz — render time per
     view, PSNR / mIoU / PQ beside artifacts/torch/
     synthetic_flagship_10000_jax_eval.json, and the kernel's launch count,
     which must equal the number of views rendered;
  6. kernel A2 (grouped intersection) vs its plain version on 20 training
     batches (G = 8 groups of M = 256 rays, K = 16) and on a cut-plane
     case; A2 and plain times;
  7. kernels B / B' (fused trunk forward / backward) vs their plain
     versions at N = 131,072 and 262,144 points with the checkpoint's
     coarse and fine trunk weights, on the encodings of real sample points
     of a training batch: max abs and relative Frobenius error of out, dW,
     db, dx; kernel and plain times;
  8. one full-width training step from the checkpoint with the JAX step's
     recorded draws (artifacts/torch/synthetic_flagship_10000_jax_step.*):
     loss terms, grad_norm, per-leaf gradient cosines, first-update signs;
  9. the training main path: `engine.run_train` for 200 steps from
     `init_params` (seeded) into a temporary model_dir: ms/step, rays/s,
     peak memory, falling finite loss, launch counts A2 = steps and
     B = B' = 2 x steps; then `run_evaluate` on the checkpoint it wrote.
The last two lines are the kernels' JSON and `{"ok": true, "device": ...}`.
"""

import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CFG_FILE = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
REF_JSON = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_eval.json")
STEP_NPZ = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_step.npz")
STEP_JSON = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_step.json")
KERNEL_SOURCE = "panopticnerf_tpu_torch/csrc/intersect.cu"
KERNEL_REPLACES = "panopticnerf_tpu/ops/pallas_intersect.py:222"
A2_REPLACES = "panopticnerf_tpu/ops/pallas_intersect.py:294"
TRUNK_SOURCE = "panopticnerf_tpu_torch/csrc/mlp_train.cu"
B_REPLACES = "panopticnerf_tpu/ops/pallas_mlp_train.py:186"
B2_REPLACES = "panopticnerf_tpu/ops/pallas_mlp_train.py:217"
MAX_FLIP_SHARE = 1e-3     # share of (ray, slot) entries allowed to differ
MAX_DT = 1e-4             # |dt| allowed where kernel and plain agree
TOL = {"psnr": 0.1, "miou": 0.005, "pq": 0.01}  # vs the JAX reference
# B / B' vs plain, relative Frobenius error: summation order differs on the
# card, so bf16 roundings of activations, g and dW flip in places (measured
# at most 8.0e-4, dW of the fine trunk; NVIDIA H100 80GB HBM3, 700 W).
MAX_TRUNK_REL = 2e-3
# one step vs the JAX record, where bf16 roundings flip between the packages
# (measured: loss terms <= 6.6e-4, grad_norm 4.4e-3, min cosine 0.9993,
# update signs 0.9959 on the same card)
STEP_REL = 1e-2           # loss terms and grad_norm, relative
MIN_COSINE = 0.995        # per-leaf gradient cosine
MIN_SIGN_SHARE = 0.99     # entries whose first Adam update has JAX's sign
TRAIN_STEPS = 200


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def compare(out, ref):
    """-> (entries, differing entries, max |dt| over agreeing hit entries)."""
    agree = ((out.mask == ref.mask) & (out.semantic == ref.semantic)
             & (out.instance == ref.instance))
    both = agree & out.mask
    dt = 0.0
    if bool(both.any()):
        dt = max(float((out.t_in - ref.t_in).abs()[both].max()),
                 float((out.t_out - ref.t_out).abs()[both].max()))
    return agree.numel(), int((~agree).sum()), dt


def cut_planes(p, f, seed):
    """(P, F, 4) half-spaces n.x <= 0 through each box centre (the local
    origin), with normals turned so that every box keeps a non-empty cone."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(p, 1, 3))
    n = rng.normal(size=(p, f, 3))
    n = np.where((n * axis).sum(-1, keepdims=True) > 0, -n, n)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.ascontiguousarray(np.concatenate([n, np.zeros((p, f, 1))], -1), np.float32)


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def ptxas_summary(log_path):
    """'kernel: R registers, static smem S B, spills' lines from nvcc's
    -Xptxas -v log (the kernels' dynamic shared memory is set at launch)."""
    out, name, spills = [], None, ""
    for line in open(log_path):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?\d+(trunk_\w+?)(ILi(\d+)EE)?E.*$",
                          lambda k: k.group(1) + (f"<{k.group(3)}>" if k.group(3) else ""),
                          m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, static smem {m.group(2) or 0} B, {spills}")
    return out


def a2_phase(cfg, ds, train_ids, dev, intersect_cuda):
    """Kernel A2 vs plain on 20 training batches (+ a cut-plane case)."""
    from panopticnerf_tpu_torch.data.dataset import sample_ray_batch
    from panopticnerf_tpu_torch.ops.intersect import Primitives, intersect_groups_plain

    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    g, n = cfg.data.views_per_batch, cfg.data.n_rays
    view_ids = torch.as_tensor(train_ids, device=dev)
    gen = torch.Generator(dev).manual_seed(1234)
    max_dt = 0.0

    def grouped(batch):
        gv = batch.view.reshape(g, n // g)[:, 0]
        prims = Primitives(ds.prim_w2p[gv], ds.prim_sem[gv], ds.prim_inst[gv],
                           ds.prim_valid[gv], None)
        return batch.rays_o.reshape(g, n // g, 3), batch.rays_d.reshape(g, n // g, 3), prims

    for case, f in (("F=0", 0), ("F=8", 8)):
        total = bad = hits = 0
        for b in range(20 if f == 0 else 4):
            ro, rd, prims = grouped(sample_ray_batch(ds, view_ids, n, g, gen))
            if f:
                p = prims.world_to_prim.shape[1]
                prims = prims._replace(cut_planes=torch.from_numpy(np.stack(
                    [cut_planes(p, f, 100 * b + i) for i in range(g)])).to(dev))
            out = intersect_cuda.intersect_groups_cuda(ro, rd, prims, near, far, k)
            ref = intersect_groups_plain(ro, rd, prims, near, far, k)
            torch.cuda.synchronize()
            nn_, nb, dt = compare(out, ref)
            total, bad, max_dt = total + nn_, bad + nb, max(max_dt, dt)
            hits += int(out.mask.sum())
        share = bad / total
        print(f"A2 vs plain, {case}: {20 if f == 0 else 4} training batches x G={g} x "
              f"M={n // g} x K={k}: {bad} of {total} entries differ ({share:.2e}), max |dt| "
              f"where they agree {max_dt:.3e} ({hits} hit slots)")
        check(share <= MAX_FLIP_SHARE, f"A2 {case}: flip share {share} > {MAX_FLIP_SHARE}")
        check(max_dt <= MAX_DT, f"A2 {case}: max |dt| {max_dt} > {MAX_DT}")
    ro, rd, prims = grouped(sample_ray_batch(ds, view_ids, n, g, gen))
    run_k = lambda: intersect_cuda.intersect_groups_cuda(ro, rd, prims, near, far, k)
    run_p = lambda: intersect_groups_plain(ro, rd, prims, near, far, k)
    plain_ms, kernel_ms = time_ms(run_p), time_ms(run_k)
    plain_ms2, kernel_ms2 = time_ms(run_p), time_ms(run_k)
    print(f"A2 at G={g}, M={n // g}, K={k}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms2:.4f} ms (median of 20, plain-kernel-plain-kernel)")
    return max_dt, kernel_ms, plain_ms


def trunk_phase(cfg, ds, train_ids, model, dev):
    """Kernels B / B' vs plain at the step's point counts, with the
    checkpoint's trunk weights on the encodings of real sample points."""
    from panopticnerf_tpu_torch.data.dataset import batch_intervals, sample_ray_batch
    from panopticnerf_tpu_torch.ops import mlp_train as mt
    from panopticnerf_tpu_torch.ops.encoding import positional_encoding
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_backward_cuda, trunk_forward_cuda
    from panopticnerf_tpu_torch.render import SceneBounds, render_rays

    g, n = cfg.data.views_per_batch, cfg.data.n_rays
    gen = torch.Generator(dev).manual_seed(99)
    batch = sample_ray_batch(ds, torch.as_tensor(train_ids, device=dev), n, g, gen)
    iv = batch_intervals(ds, batch, cfg.render.near, cfg.render.far, cfg.data.max_intervals, g)
    with torch.no_grad():
        out = render_rays(model, batch.rays_o, batch.rays_d,
                          SceneBounds(ds.bounds_center, ds.bounds_scale), cfg, iv=iv,
                          train=True, generator=gen)
    res = {}
    for field, z in (("coarse", out.coarse.z), ("fine", out.z)):
        net = getattr(model, field)
        pts = batch.rays_o[:, None] + batch.rays_d[:, None] * z[..., None]
        pts = (pts - ds.bounds_center) * ds.bounds_scale
        x_enc = positional_encoding(pts.reshape(-1, 3), cfg.model.xyz_freqs).to(torch.bfloat16)
        layers = [getattr(net, f"trunk_{i}") for i in range(cfg.model.trunk_depth)]
        skips = tuple(s + 1 for s in cfg.model.skips if s + 1 < cfg.model.trunk_depth)
        wp, bp = mt.pack_trunk([m.weight.t() for m in layers], [m.bias for m in layers],
                               skips, torch.bfloat16)
        xp = mt.pad_x(x_enc)
        npts = xp.shape[0]
        gout = torch.randn((npts, wp.shape[-1]), generator=gen, device=dev) * 1e-3
        acts = trunk_forward_cuda(xp, wp, bp, skips)
        acts_ref = mt.trunk_forward_plain(xp, wp, bp, skips)
        got = trunk_backward_cuda(xp, acts, gout, wp, skips)
        ref = mt.trunk_backward_plain(xp, acts, gout, wp, skips)
        torch.cuda.synchronize()
        errs = {"out": (acts[-1], acts_ref[-1]), "dW": (got[1], ref[1]),
                "db": (got[2], ref[2]), "dx": (got[0], ref[0])}
        line = []
        for name, (a, b) in errs.items():
            check(bool(torch.isfinite(a.float()).all()), f"B/B' {field}: non-finite {name}")
            r, m = rel_err(a, b), float((a.float() - b.float()).abs().max())
            line.append(f"{name} max|d| {m:.3e} rel {r:.3e}")
            check(r <= MAX_TRUNK_REL, f"B/B' {field} N={npts}: {name} rel err {r} > {MAX_TRUNK_REL}")
            res[(field, name)] = (m, r)
        t = {}
        t["fwd_plain"] = time_ms(lambda: mt.trunk_forward_plain(xp, wp, bp, skips), reps=5, warmup=1)
        t["fwd"] = time_ms(lambda: trunk_forward_cuda(xp, wp, bp, skips), reps=5, warmup=1)
        t["bwd_plain"] = time_ms(lambda: mt.trunk_backward_plain(xp, acts, gout, wp, skips), reps=5, warmup=1)
        t["bwd"] = time_ms(lambda: trunk_backward_cuda(xp, acts, gout, wp, skips), reps=5, warmup=1)
        t["fwd2"] = time_ms(lambda: trunk_forward_cuda(xp, wp, bp, skips), reps=5, warmup=1)
        t["fwd_plain2"] = time_ms(lambda: mt.trunk_forward_plain(xp, wp, bp, skips), reps=5, warmup=1)
        t["bwd2"] = time_ms(lambda: trunk_backward_cuda(xp, acts, gout, wp, skips), reps=5, warmup=1)
        t["bwd_plain2"] = time_ms(lambda: mt.trunk_backward_plain(xp, acts, gout, wp, skips), reps=5, warmup=1)
        res[(field, "t")] = t
        print(f"B/B' vs plain, {field} trunk, N={npts}: " + "; ".join(line))
        print(f"  times (ms, median of 5, plain-kernel-kernel-plain): B {t['fwd']:.3f} / "
              f"{t['fwd2']:.3f}, plain {t['fwd_plain']:.3f} / {t['fwd_plain2']:.3f}; "
              f"B' {t['bwd']:.3f} / {t['bwd2']:.3f}, plain {t['bwd_plain']:.3f} / "
              f"{t['bwd_plain2']:.3f}")
        del acts, acts_ref, got, ref
    return res


def step_phase(cfg, ds, dev):
    """One flagship step from the 10k checkpoint with the JAX step's draws."""
    from panopticnerf_tpu_torch.convert import load_npz, params_to_flax
    from panopticnerf_tpu_torch.data.dataset import BatchDraws
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render import RenderDraws
    from panopticnerf_tpu_torch.train import StepDraws, make_train_state, make_train_step

    with open(STEP_JSON) as fh:
        ref = json.load(fh)
    z = np.load(STEP_NPZ)
    model = make_network(cfg, dev)
    model.load_state_dict(load_npz(os.path.join(REPO, "artifacts", "torch",
                                                "synthetic_flagship_10000.npz")))
    old = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = make_train_state(cfg, model)
    step = make_train_step(cfg, model)
    t = lambda key: torch.from_numpy(z[f"draw/{key}"]).to(dev) if f"draw/{key}" in z else None
    draws = StepDraws(BatchDraws(t("group"), t("u"), t("v")),
                      RenderDraws(t("coarse"), t("bg"), t("fine"), t("noise_coarse"),
                                  t("noise_fine")))
    view_ids = torch.from_numpy(z["view_ids"]).to(dev)
    stats = {k: float(v) for k, v in step(state, ds, view_ids, None, draws).items()}
    for key, want in sorted(ref["stats"].items()):
        got = stats[key]
        r = abs(got - want) / max(abs(want), 1e-12)
        print(f"  step {key}: port {got:.6f}  JAX {want:.6f}  rel {r:.2e}")
        check(np.isfinite(got), f"step {key} not finite")
        if key.startswith("loss_") or key == "grad_norm":
            check(r <= STEP_REL or abs(got - want) <= 1e-6,
                  f"step {key} off the JAX record ({r:.3e} > {STEP_REL})")
    # a leaf no loss reaches (the coarse semantic head) has no .grad; JAX's is 0
    grads = params_to_flax({k: torch.zeros_like(p) if p.grad is None else p.grad
                            for k, p in model.named_parameters()})
    new = params_to_flax({k: v - old[k] for k, v in model.state_dict().items()})
    cos_min, agree, total = 1.0, 0, 0
    for name in sorted(grads):
        a = grads[name].astype(np.float64).ravel()
        b = z[f"grad_dir/{name}"].astype(np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        cos = 1.0 if na == nb == 0 else float(a @ b / max(na * nb, 1e-30))
        cos_min = min(cos_min, cos)
        if cos < MIN_COSINE:
            print(f"  leaf {name}: gradient cosine {cos:.5f}")
        s = np.sign(new[name]).astype(np.int8).ravel()
        agree += int((s == z[f"update_sign/{name}"].ravel()).sum())
        total += s.size
    print(f"one flagship step vs JAX: min per-leaf gradient cosine {cos_min:.5f} over "
          f"{len(grads)} leaves; first Adam update sign agrees on {agree} of {total} entries "
          f"({agree / total:.4f})")
    check(cos_min >= MIN_COSINE, f"gradient cosine {cos_min} < {MIN_COSINE}")
    check(agree / total >= MIN_SIGN_SHARE,
          f"first-update sign agreement {agree / total} < {MIN_SIGN_SHARE}")
    return stats, cos_min, agree / total


def train_phase(cfg, dev, engine):
    """The training main path through A2, B and B'; then an evaluation of
    the checkpoint it wrote."""
    import dataclasses

    from panopticnerf_tpu_torch.ops import intersect_cuda, mlp_train_cuda

    with tempfile.TemporaryDirectory() as tmp:
        tcfg = dataclasses.replace(cfg, model_dir=tmp)
        torch.cuda.reset_peak_memory_stats(dev)
        intersect_cuda.intersect_groups_cuda.launches = 0
        mlp_train_cuda.trunk_forward_cuda.launches = 0
        mlp_train_cuda.trunk_backward_cuda.launches = 0
        t0 = time.perf_counter()
        res = engine.run_train(tcfg, dev, max_steps=TRAIN_STEPS, log=lambda *a: None)
        wall = time.perf_counter() - t0
        launches = {"A2": intersect_cuda.intersect_groups_cuda.launches,
                    "B": mlp_train_cuda.trunk_forward_cuda.launches,
                    "B'": mlp_train_cuda.trunk_backward_cuda.launches}
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        losses = res["losses"]
        ms = [1000.0 * s / k for k, s in res["windows"][1:]]  # the first window warms up
        ms_step = float(np.median(ms))
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        print(f"run_train: {TRAIN_STEPS} steps of {cfg.data.n_rays} rays in {wall:.2f} s; "
              f"median {ms_step:.3f} ms/step over {len(ms)} windows of "
              f"{cfg.train.log_interval} after the first (range {min(ms):.3f}-{max(ms):.3f}), "
              f"{cfg.data.n_rays / ms_step * 1000:.0f} rays/s; peak device memory {peak:.0f} MiB")
        print(f"  loss_total mean of the first 20 steps {first:.5f}, last 20 {last:.5f}; "
              f"launches {launches}")
        check(bool(np.isfinite(losses).all()), "non-finite training loss")
        check(last < first, f"training loss did not fall ({first} -> {last})")
        want = {"A2": TRAIN_STEPS, "B": 2 * TRAIN_STEPS, "B'": 2 * TRAIN_STEPS}
        check(launches == want, f"launch counts {launches}, expected {want}")
        ecfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train,
                                                                   eval_step=TRAIN_STEPS))
        ev = engine.run_evaluate(ecfg, dev, log=lambda *a: None)
        print(f"  run_evaluate of the {TRAIN_STEPS}-step checkpoint: PSNR {ev['psnr']:.4f}, "
              f"mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}")
        check(all(np.isfinite(ev[k]) for k in ("psnr", "miou", "pq")), "non-finite scores")
    return launches, ms_step


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.ops import _nvcc, intersect_cuda, mlp_train_cuda
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. card and versions
    print(sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{sh([_nvcc.nvcc_path(), '--version']).splitlines()[-1]}")

    # 2. build: one nvcc per source, run together
    libs = {name: _nvcc.library_path(name) for name in ("intersect", "mlp_train")}
    existed = {name: os.path.exists(path) for name, path in libs.items()}
    t0 = time.perf_counter()
    _nvcc.build_all(libs)
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"build: {name}.cu -> {os.path.relpath(path, REPO)}: "
              + ("an existing build, loaded" if existed[name]
                 else f"compiled with nvcc in {secs:.2f} s (both sources together)"))
    intersect_cuda.load()
    mlp_train_cuda.load()
    for line in ptxas_summary(libs["mlp_train"][:-3] + ".log"):
        print(f"  ptxas {line}")

    # 3. kernel vs plain at the slice's shape
    cfg = load_config(CFG_FILE, ["model_dir", os.path.join(REPO, "artifacts")])
    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    ds, _, model, _ = engine._restore_for_eval(cfg, dev)
    n_views = ds.images.shape[0]
    max_dt = 0.0
    for case, f in (("F=0", 0), ("F=8", 8)):
        total = bad = 0
        for v in range(n_views):
            o, d = view_rays(ds, v)
            prims = view_primitives(ds, v)
            if f:
                p = prims.world_to_prim.shape[0]
                prims = prims._replace(cut_planes=torch.from_numpy(cut_planes(p, f, v)).to(dev))
            out = intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
            ref = intersect_rays_plain(o, d, prims, near, far, k)
            torch.cuda.synchronize()
            n, nb, dt = compare(out, ref)
            total, bad, max_dt = total + n, bad + nb, max(max_dt, dt)
            hits = int(out.mask.sum())
        share = bad / total
        print(f"kernel vs plain, {case}: {n_views} views x {o.shape[0]} rays x K={k} "
              f"(P={prims.world_to_prim.shape[0]}): {bad} of {total} entries differ "
              f"({share:.2e}), max |dt| where they agree {max_dt:.3e} "
              f"(last view: {hits} hit slots)")
        check(share <= MAX_FLIP_SHARE, f"{case}: flip share {share} > {MAX_FLIP_SHARE}")
        check(max_dt <= MAX_DT, f"{case}: max |dt| {max_dt} > {MAX_DT}")

    # 4. times at the view shape
    o, d = view_rays(ds, 0)
    prims = view_primitives(ds, 0)
    run_k = lambda: intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
    run_p = lambda: intersect_rays_plain(o, d, prims, near, far, k)
    plain_ms, kernel_ms = time_ms(run_p), time_ms(run_k)
    plain_ms2, kernel_ms2 = time_ms(run_p), time_ms(run_k)
    print(f"intersect at N={o.shape[0]}, P={prims.world_to_prim.shape[0]}, K={k}: "
          f"kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms2:.4f} ms (median of 20, plain-kernel-plain-kernel)")

    # 5. the main path
    intersect_cuda.intersect_rays_cuda.launches = 0
    res = engine.run_evaluate(cfg, dev, log=lambda *a: None)
    launches = intersect_cuda.intersect_rays_cuda.launches
    secs = res["render_seconds"]
    print(f"run_evaluate: {len(res['views'])} views, render s/view "
          + " ".join(f"{s:.3f}" for s in secs)
          + f" (median {np.median(secs):.3f}, first view includes warm-up); "
          f"kernel launches {launches}")
    check(launches == len(res["views"]),
          f"kernel launched {launches} times for {len(res['views'])} views")
    with open(REF_JSON) as fh:
        ref = json.load(fh)
    check(sorted(ref["views"]) == sorted(res["views"]),
          f"reference covers views {ref['views']}, the port rendered {res['views']}")
    for key, tol in TOL.items():
        a, b = res[key], ref["overall"][key]
        print(f"  {key}: port {a:.6f}  JAX reference {b:.6f}  |d| {abs(a - b):.6f} (tol {tol})")
        check(np.isfinite(a) and abs(a - b) <= tol, f"{key} off the reference")
    view = int(ref["psnr_views"][0])
    out = engine._render_view(cfg, model, ds, view)
    h, w = ds.images.shape[1:3]
    check(tuple(out.rgb.shape) == (h * w, 3) and bool(torch.isfinite(out.rgb).all())
          and bool(torch.isfinite(out.sem_logits).all()), "non-finite or misshaped render")

    # 6-9. the training slice
    from panopticnerf_tpu_torch.data import make_dataset

    ds_t, train_ids, _ = make_dataset(cfg, dev)
    a2_dt, a2_ms, a2_plain_ms = a2_phase(cfg, ds_t, train_ids, dev, intersect_cuda)
    trunk = trunk_phase(cfg, ds_t, train_ids, model, dev)
    step_phase(cfg, ds_t, dev)
    del ds_t
    torch.cuda.empty_cache()
    train_launches, _ = train_phase(cfg, dev, engine)

    tf = trunk[("fine", "t")]
    print(json.dumps({"kernels": [
        {"name": "intersect_rays", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_dt,
         "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "intersect_groups", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": A2_REPLACES, "launches": train_launches["A2"], "max_abs_err": a2_dt,
         "ms": a2_ms, "plain_ms": a2_plain_ms},
        {"name": "trunk_forward", "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": B_REPLACES, "launches": train_launches["B"],
         "max_abs_err": trunk[("fine", "out")][0], "ms": tf["fwd"], "plain_ms": tf["fwd_plain"]},
        {"name": "trunk_backward", "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": B2_REPLACES, "launches": train_launches["B'"],
         "max_abs_err": trunk[("fine", "dW")][0], "ms": tf["bwd"], "plain_ms": tf["bwd_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
