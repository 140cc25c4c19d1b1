#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: builds its CUDA kernel, holds it
against its plain PyTorch version, then runs the port's evaluation of the
committed flagship checkpoint and holds the scores against the JAX
package's recorded ones.

    python3 chip_smoke.py          # from the repo root, on a machine with one NVIDIA GPU

Phases (any failure raises; the exit code is then non-zero and no result
line is printed):
  1. card, power limit, torch / CUDA / nvcc versions;
  2. build of csrc/intersect.cu with nvcc (timed);
  3. kernel vs plain version on every synthetic_flagship view
     (N = 33,088 rays, P = 32, K = 16, F = 0) and on a cut-plane case
     (F = 8 seeded half-spaces through each box centre): share of
     (ray, slot) entries that differ, max |dt| where they agree;
  4. median kernel and plain times at the view shape (CUDA events);
  5. the main path: `engine.run_evaluate` on configs/synthetic_flagship.yaml
     with artifacts/torch/synthetic_flagship_10000.npz — render time per
     view, PSNR / mIoU / PQ beside artifacts/torch/
     synthetic_flagship_10000_jax_eval.json, and the kernel's launch count,
     which must equal the number of views rendered.
The last two lines are the kernels' JSON and `{"ok": true, "device": ...}`.
"""

import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CFG_FILE = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
REF_JSON = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_eval.json")
KERNEL_SOURCE = "panopticnerf_tpu_torch/csrc/intersect.cu"
KERNEL_REPLACES = "panopticnerf_tpu/ops/pallas_intersect.py:222"
MAX_FLIP_SHARE = 1e-3     # share of (ray, slot) entries allowed to differ
MAX_DT = 1e-4             # |dt| allowed where kernel and plain agree
TOL = {"psnr": 0.1, "miou": 0.005, "pq": 0.01}  # vs the JAX reference


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.ops import _nvcc, intersect_cuda
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. card and versions
    print(sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{sh([_nvcc.nvcc_path(), '--version']).splitlines()[-1]}")

    # 2. build
    lib = os.path.relpath(_nvcc.library_path("intersect"), REPO)
    existed = os.path.exists(lib)
    t0 = time.perf_counter()
    intersect_cuda.load()
    print(f"build: intersect.cu -> {lib}: "
          + ("an existing build, loaded" if existed
             else f"compiled with nvcc in {time.perf_counter() - t0:.2f} s"))

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

    print(json.dumps({"kernels": [{
        "name": "intersect_rays", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_dt,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
