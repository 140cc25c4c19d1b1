"""Times kernels B, B', C and C' (C' on saved activations) of the PyTorch
port at the flagship step's point counts, and the intersection kernel A1 /
A2 at its evaluation and training shapes, with the device time of each CUDA
kernel inside them.

    python tools/bench_backward.py [--root DIR]

`--root` is the repository whose `panopticnerf_tpu_torch` is imported
(default: the one holding this script), so that one call can time two
trees with the same script, in turns. Inputs are seeded random values at
the widths of configs/synthetic_flagship.yaml: an 8 x 256 trunk with the
skip at kernel layer 5, 128-wide semantic and colour heads, 19 classes,
x_enc 63 and d_enc 27 columns; N = 131,072 (coarse) and 262,144 (fine);
for A1 one table of P = 32 seeded oriented boxes against 33,088 rays (a
flagship view), for A2 G = 8 tables against 256 rays each, K = 16, near
0.5, far 40, half the rays aimed at a box. Prints one JSON line per
(kernel, N): the median ms of 10 calls timed with CUDA events, the device
ms of each CUDA kernel inside one call (torch.profiler, averaged over 3
calls; C''s line also gives its heads data pass alone, `heads_ms`), for A1
/ A2 the median host time of one wrapper call (`host_ms`), and, where the
tree's wrappers define them, the byte floors at 3.35 TB/s: B's and C's
design floor (their own I/O and the activations they save), the
three-pass plan's of B' and C', C''s heads data pass's, A1's and A2's.
Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES = 3.35e12
REPS = 10


def boxes(rng, g, p, m, dev):
    """G tables of P seeded oriented boxes and M rays per table, half of
    them aimed at a box: (Primitives with a leading G, rays_o, rays_d)."""
    from panopticnerf_tpu_torch.ops.intersect import Primitives

    c = rng.uniform(-6, 6, (g, p, 3))
    c[..., 2] = rng.uniform(4, 18, (g, p))
    q, _ = np.linalg.qr(rng.normal(size=(g, p, 3, 3)))
    lin = (2.0 / rng.uniform(0.8, 4.0, (g, p, 3)))[..., None] * np.swapaxes(q, -1, -2)
    w2p = np.concatenate([lin, -np.einsum("gpij,gpj->gpi", lin, c)[..., None]], -1)
    o = rng.uniform(-2, 2, (g, m, 3))
    d = rng.normal(size=(g, m, 3))
    d[..., 2] = np.abs(d[..., 2]) + 0.3
    aim = np.take_along_axis(c, rng.integers(0, p, (g, m // 2, 1)), 1)
    d[:, : m // 2] = aim + rng.uniform(-1, 1, (g, m // 2, 3)) - o[:, : m // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    prims = Primitives(t(w2p), t(rng.integers(0, 19, (g, p)), torch.int32),
                       t(rng.integers(1, 900, (g, p)), torch.int32),
                       t(rng.uniform(size=(g, p)) > 0.15, torch.bool))
    return prims, t(o), t(d)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_backward: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from panopticnerf_tpu_torch.ops import field_train as ft
    from panopticnerf_tpu_torch.ops import field_train_cuda as fc
    from panopticnerf_tpu_torch.ops import intersect_cuda as ic
    from panopticnerf_tpu_torch.ops import mlp_train as mt
    from panopticnerf_tpu_torch.ops import mlp_train_cuda as mc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; tree {os.path.abspath(args.root)}; package {os.path.dirname(mt.__file__)}")
    width, layers, skips, f, dd, classes, cw = 256, 8, (5,), 63, 27, 19, 128
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    dims = ft.FieldDims(x_dim=f, d_dim=dd, width=width, sem_hidden=width // 2, color_width=cw,
                        num_classes=classes, layers=layers, skips=skips, use_sem=True)
    ins = {f"trunk_{i}": f if i == 0 else width + (f if i in skips else 0) for i in range(layers)}
    ins.update(sem_hidden=width, sem_out=width // 2, feature=width, sigma=width,
               color_hidden=width + dd, color_out=cw)
    outs = {f"trunk_{i}": width for i in range(layers)}
    outs.update(sem_hidden=width // 2, sem_out=classes, feature=width, sigma=1, color_hidden=cw,
                color_out=3)
    params = []
    for name in dims.leaves():
        params.append(t(rng.normal(size=(outs[name], ins[name])) * np.sqrt(2.0 / ins[name])))
        params.append(t(rng.normal(size=(outs[name],)) * 0.1))
    pk = ft.pack_field(params, dims, torch.bfloat16)

    def timed(fn):
        for _ in range(2):
            fn()
        ms = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        passes = {e.key[:90]: round(e.self_device_time_total / 3e3, 4)
                  for e in prof.key_averages() if e.self_device_time_total > 0}
        return float(np.median(ms)), passes

    def host(fn):
        ms = []
        for _ in range(50):
            t0 = time.perf_counter()
            fn()
            ms.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        return float(np.median(ms))

    for name, g, m in (("A1", 1, 33088), ("A2", 8, 256)):
        prims, ro, rd = boxes(rng, g, 32, m, dev)
        if g == 1:
            one = type(prims)(*[a[0] for a in prims[:4]])
            fn = lambda: ic.intersect_rays_cuda(ro[0], rd[0], one, 0.5, 40.0, 16)
        else:
            fn = lambda: ic.intersect_groups_cuda(ro, rd, prims, 0.5, 40.0, 16)
        ms, passes = timed(fn)
        line = {"kernel": name, "n": g * m, "ms": ms, "passes_ms": passes, "host_ms": host(fn)}
        if hasattr(ic, "intersect_plan_bytes"):
            line["floor_ms"] = 1e3 * ic.intersect_plan_bytes(g, m, 32, 0, 16) / PEAK_BYTES
        print(json.dumps(line))

    for n in (131072, 262144):
        x = np.zeros((n, mt.F_PAD), np.float32)
        x[:, :f] = rng.uniform(-1, 1, (n, f))
        d = np.zeros((n, ft.D_PAD), np.float32)
        d[:, :dd] = rng.uniform(-1, 1, (n, dd))
        xp, dp = t(x).to(torch.bfloat16), t(d).to(torch.bfloat16)
        g = t(rng.normal(size=(n, width)) * 1e-3)
        g_out, g_sem = t(rng.normal(size=(n, 4)) * 1e-3), t(rng.normal(size=(n, classes)) * 1e-3)
        ms, passes = timed(lambda: mc.trunk_forward_cuda(xp, pk.wp, pk.bp, skips))
        line = {"kernel": "B", "n": n, "ms": ms, "passes_ms": passes}
        if hasattr(mc, "forward_plan_bytes"):
            line["floor_ms"] = 1e3 * mc.forward_plan_bytes(n, width, layers) / PEAK_BYTES
        print(json.dumps(line))
        ms, passes = timed(lambda: fc.field_forward_cuda(xp, dp, pk, dims))
        line = {"kernel": "C", "n": n, "ms": ms, "passes_ms": passes}
        if hasattr(fc, "forward_plan_bytes"):
            line["floor_ms"] = 1e3 * fc.forward_plan_bytes(n, dims) / PEAK_BYTES
        print(json.dumps(line))
        acts = mc.trunk_forward_cuda(xp, pk.wp, pk.bp, skips)
        ms, passes = timed(lambda: mc.trunk_backward_cuda(xp, acts, g, pk.wp, skips))
        floor = getattr(mc, "backward_plan_bytes", None)
        line = {"kernel": "B'", "n": n, "ms": ms, "passes_ms": passes}
        if floor:
            line["floor_ms"] = [1e3 * b / PEAK_BYTES for b in floor(n, width, layers, skips)]
        print(json.dumps(line))
        del acts
        saved = fc.field_forward_cuda(xp, dp, pk, dims)[2]
        ms, passes = timed(lambda: fc.field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, saved,
                                                          torch.bfloat16))
        line = {"kernel": "C'", "n": n, "ms": ms, "passes_ms": passes,
                "heads_ms": sum(v for k, v in passes.items() if "heads_kernel" in k),
                "heads_floor_ms": 1e3 * fc.heads_data_plan_bytes(n, dims) / PEAK_BYTES}
        if floor:
            line["floor_ms"] = [1e3 * b / PEAK_BYTES for b in floor(n, width, layers, skips)]
            line["heads_weight_floor_ms"] = 1e3 * fc.heads_weight_plan_bytes(n, dims) / PEAK_BYTES
        print(json.dumps(line))
        del saved
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
