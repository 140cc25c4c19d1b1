"""Kernel V (the evaluation render's compositing) against its roofline: the least time of the
traced views' compositing, its own bytes at HBM's rate, over V's device time there (layer
`renderer` of `kernel_names/`). Both levels of every ray count. Per point: the field's f32
sigma, rgb and learned logits (where the configuration has the semantic head), z (and the
keep-M delta at the fine level where the configuration keeps M samples) read, the weight
written. Per ray and level: with primitives the K intervals read (f32 entry and exit, int32
label, bool mask); the maps written (rgb, depth, acc, the learned logits, and with primitives
the instance mass and the fixed map). V's f32 operations, ~100 a point, would take a
fifteenth of that at the f32 peak, so bytes decide. None where no kernel of the layer ran (a
program without V)."""

from harness import yardstick as ys

LAYERS = ()


def level_bytes(samples: int, classes: int, intervals: int, fixed_classes: int,
                delta: bool) -> int:
    """V's own bytes for one ray at one level."""
    point = 4 + 12 + 4 * classes + 4 + 4 + (4 if delta else 0)
    ray = 12 + 4 + 4 + 4 * classes
    if intervals:
        ray += intervals * (4 + 4 + 4 + 1) + 4 * intervals + 4 * fixed_classes
    return samples * point + ray


def read(ctx):
    layer = ctx["trace"]["layers"].get("renderer")
    if not layer or not layer["events"] or layer["seconds"] <= 0:
        return None
    cfg = ctx["cfg"]
    m, r = cfg.model, cfg.render
    coarse = r.eval_n_samples or r.n_samples
    importance = r.eval_n_importance if r.eval_n_importance >= 0 else r.n_importance
    classes = m.num_classes if m.use_semantic else 0
    k = cfg.data.max_intervals if r.use_primitives else 0
    per_ray = level_bytes(coarse, classes, k, m.num_classes, False)
    if importance > 0:
        fine = coarse + importance
        keep = 0 < r.eval_keep_samples < fine
        per_ray += level_bytes(r.eval_keep_samples if keep else fine, classes, k, m.num_classes,
                               keep)
    least_s = per_ray * ctx["n_rays"] * ctx["trace"]["units"] / ys.PEAK_BYTES
    return 100.0 * least_s / layer["seconds"]
