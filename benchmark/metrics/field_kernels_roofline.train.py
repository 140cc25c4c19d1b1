"""The training field's kernels against their roofline: the summed least
time of the step's field forward and backward calls (B / B' in mode
trunk, C / C' in mode field, C' in mode hybrid, on every field that is not
a small proposal coarse), over the device time of the kernels of layer
`field_train` in the profiled stretch."""

from harness import yardstick as ys

LAYERS = ("field_train",)


def read(ctx):
    cfg = ctx["cfg"]
    m = cfg.model
    if not m.use_pallas:
        return None
    small = bool(m.coarse_trunk_depth or m.coarse_trunk_width)
    least = 0.0
    for f in ys.fields_of(cfg):
        if f["name"] == "coarse" and small and cfg.render.n_importance > 0:
            continue
        npts = ctx["n_rays"] * f["samples"]
        x_dim = ys.posenc_dim(3, f["xyz_freqs"])
        if m.pallas_mode == "trunk":
            least += ys.trunk_fwd_least_ms(npts, x_dim, f["width"], f["depth"], f["skips"])[0]
            least += ys.trunk_bwd_least_ms(npts, x_dim, f["width"], f["depth"], f["skips"])[0]
        else:
            if m.pallas_mode == "field":
                least += ys.field_fwd_least_ms(npts, f)[0]
            least += ys.field_bwd_least_ms(npts, f)[0]
    tr = ctx["trace"]
    dev_s = tr["layers"]["field_train"]["seconds"]
    return 100.0 * least * 1e-3 * tr["units"] / dev_s
