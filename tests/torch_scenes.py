"""Seeded random scenes for the port's intersection tests (numpy only, so
that the card-only tests, which must run where JAX is absent, share them
with the JAX parity tests), and the overrides of a tiny engine run."""

import numpy as np


def random_boxes(rng, p, f=0, dup=0):
    """Random oriented boxes: ((w2p (P, 3, 4), sem, inst, valid, planes |
    None), centres). The last `dup` copy the first ones' geometry but keep
    their own labels (exact entry-depth ties whose order is observable);
    `f` > 0 adds half-spaces n.x <= b around each box centre."""
    centers = rng.uniform(-6, 6, (p, 3))
    centers[:, 2] = rng.uniform(4, 18, p)
    sizes = rng.uniform(0.8, 4.0, (p, 3))
    q, _ = np.linalg.qr(rng.normal(size=(p, 3, 3)))
    lin = (2.0 / sizes)[:, :, None] * np.swapaxes(q, 1, 2)
    trans = -np.einsum("pij,pj->pi", lin, centers)
    w2p = np.ascontiguousarray(np.concatenate([lin, trans[:, :, None]], 2), np.float32)
    sem = rng.integers(0, 19, p).astype(np.int32)
    inst = rng.integers(1, 900, p).astype(np.int32)
    valid = rng.uniform(size=p) > 0.15
    if dup:
        w2p[-dup:] = w2p[:dup]
        valid[-dup:] = valid[:dup] = True
    planes = None
    if f:
        n = rng.normal(size=(p, f, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        planes = np.ascontiguousarray(
            np.concatenate([n, rng.uniform(0.0, 0.7, (p, f, 1))], -1), np.float32)
    return (w2p, sem, inst, valid, planes), centers


def random_rays(rng, n, centers, n_zero=0, n_away=0):
    """(o, d) float32: half the rays aim near a box centre; the next
    `n_away` point away from every box (no hits); the last `n_zero` have
    zero direction, like the full-image render's padding rays."""
    o = rng.uniform(-2, 2, (n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.3
    aim = centers[rng.integers(0, len(centers), n // 2)] + rng.uniform(-1, 1, (n // 2, 3))
    d[: n // 2] = aim - o[: n // 2]
    if n_away:
        d[n // 2: n // 2 + n_away] = [0.0, 0.0, -1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if n_zero:
        d[-n_zero:] = 0.0
    return o.astype(np.float32), d.astype(np.float32)


def engine_opts(root, exp_name="enginetest", **train):
    """KEY VALUE overrides of a tiny engine run (16x24, 6 views, a 2x16
    field in float32, 64 rays) writing under `root`; `train` overrides
    train.* keys (ep_iter 5; no saves, evaluations, recorder lines or
    resume by default).
    Both packages' `load_config(None, opts)` read them."""
    t = dict(lr="5e-3", max_steps="100", ep_iter="5", log_interval="5",
             record_interval="1000", save_ep="1000", eval_ep="1000", resume="false")
    t.update({k: str(v) for k, v in train.items()})
    return [
        "exp_name", exp_name, "model_dir", f"{root}/models", "record_dir", f"{root}/records",
        "result_dir", f"{root}/results",
        "data.synthetic_image_hw", "16,24", "data.synthetic_num_frames", "6",
        "data.synthetic_num_boxes", "3", "data.n_rays", "64", "data.views_per_batch", "4",
        "data.max_primitives", "4", "data.max_intervals", "2", "data.test_every", "3",
        "model.trunk_depth", "2", "model.trunk_width", "16", "model.color_width", "8",
        "model.num_classes", "4", "model.compute_dtype", "float32", "model.use_pallas", "true",
        "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
        "render.far", "40.0", "render.use_primitives", "true", "render.ray_tile", "128",
    ] + [x for k, v in t.items() for x in (f"train.{k}", v)]
