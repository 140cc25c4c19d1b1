"""The yardstick: published peaks of one NVIDIA H100 and the operations and
bytes of the functions the port computes, counted from shapes.

The counts are of each function's own work and its own inputs and outputs
(each input read once, each output written once), never of how the port
happens to compute it, so that they stay the same whatever implements the
function. Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the card's
full 700 W.
"""

from __future__ import annotations

PEAK_BF16 = 989e12    # tensor-core bf16 FLOP/s
PEAK_F32 = 67e12      # float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

# f32 operations of one (ray, primitive) slab test: the ray's affine
# transform (33), three slabs (21), the interval (4), the top-K insertion
# (~16 compares); and of one cut plane against one (ray, primitive) pair.
SLAB_OPS = 75
PLANE_OPS = 13


def least_ms(flops: float, moved: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of the operations over `peak` and the bytes over HBM's rate."""
    t_ops, t_bytes = 1e3 * flops / peak, 1e3 * moved / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def posenc_dim(dim: int, num_freqs: int) -> int:
    return dim * (2 * num_freqs + 1)


def trunk_shapes(x_dim: int, width: int, layers: int, skips) -> list[tuple[int, int]]:
    """(in, out) of each trunk layer; `skips` in the flax convention (the
    position encoding is concatenated AFTER layer s, so layer s + 1 reads it)."""
    return [(x_dim if i == 0 else width + (x_dim if (i - 1) in skips else 0), width)
            for i in range(layers)]


def head_shapes(width: int, x_dim: int, d_dim: int, color_width: int, num_classes: int,
                skip_last: bool) -> list[tuple[int, int]]:
    """(in, out) of every head Dense: [sem_hidden | sigma | feature] on the
    trunk output, the colour branch, and sem_out. `skip_last`: the last
    trunk layer concatenated the encoding (a skip at depth - 1)."""
    h_in = width + (x_dim if skip_last else 0)
    sem_hidden = width // 2
    return [(h_in, sem_hidden + 1 + width), (width + d_dim, color_width), (color_width, 3),
            (sem_hidden, num_classes)]


def field_shapes(f: dict) -> list[tuple[int, int]]:
    """Every Dense of one field, trunk and heads, from a field description
    (see `fields_of`)."""
    x_dim = posenc_dim(3, f["xyz_freqs"])
    d_dim = posenc_dim(3, f["dir_freqs"])
    skips = tuple(f["skips"])
    shapes = trunk_shapes(x_dim, f["width"], f["depth"], skips)
    return shapes + head_shapes(f["width"], x_dim, d_dim, f["color_width"], f["num_classes"],
                                skip_last=(f["depth"] - 1) in skips)


def fields_of(cfg) -> list[dict]:
    """The coarse and (with render.n_importance > 0) fine field of a
    program config, each with its widths and samples per ray: the coarse
    field's trunk shrinks to model.coarse_trunk_depth / width when set, and
    keeps only the skips inside its depth."""
    m, r = cfg.model, cfg.render
    has_fine = r.n_importance > 0
    base = dict(xyz_freqs=m.xyz_freqs, dir_freqs=m.dir_freqs, num_classes=m.num_classes)
    depth, width = m.trunk_depth, m.trunk_width
    coarse = dict(base, name="coarse", depth=depth, width=width, skips=tuple(m.skips),
                  color_width=m.color_width, samples=r.n_samples)
    if has_fine and (m.coarse_trunk_depth or m.coarse_trunk_width):
        cd = m.coarse_trunk_depth or depth
        cw = m.coarse_trunk_width or width
        coarse.update(depth=cd, width=cw, skips=tuple(s for s in m.skips if s < cd - 1),
                      color_width=min(m.color_width, cw))
    out = [coarse]
    if has_fine:
        out.append(dict(base, name="fine", depth=depth, width=width, skips=tuple(m.skips),
                        color_width=m.color_width, samples=r.n_samples + r.n_importance))
    return out


def macs_per_point(shapes) -> int:
    return sum(i * o for i, o in shapes)


def field_flops(cfg, n_rays: int, backward: bool) -> float:
    """Model FLOPs of both fields over `n_rays` rays: 2 x in x out per
    point and Dense layer forward, heads included, and twice that again
    for the backward (dX and dW)."""
    per_ray = sum(f["samples"] * macs_per_point(field_shapes(f)) for f in fields_of(cfg))
    return (6.0 if backward else 2.0) * n_rays * per_ray


def dense_chain_least_ms(npts: int, shapes, point_bytes: int, backward: bool = False,
                         dw_bytes: int = 2) -> tuple[float, str]:
    """least_ms of a function over a chain of bf16 Dense layers: 2 x in x
    out operations per point forward, twice that backward (dW and dX, no
    recompute); `point_bytes` per point of inputs and outputs, plus the
    bf16 weights read and the f32 biases read (forward), or the dW
    (`dw_bytes` each) and the f32 db written (backward)."""
    macs = macs_per_point(shapes)
    biases = sum(o for _, o in shapes)
    params = 2 * macs + (dw_bytes * macs + 4 * biases if backward else 4 * biases)
    return least_ms((4.0 if backward else 2.0) * npts * macs, npts * point_bytes + params)


def trunk_fwd_least_ms(npts: int, x_dim: int, width: int, layers: int, skips):
    """B: the trunk forward; in: the bf16 encoding, out: the bf16 trunk output."""
    return dense_chain_least_ms(npts, trunk_shapes(x_dim, width, layers, skips),
                                2 * x_dim + 2 * width)


def trunk_bwd_least_ms(npts: int, x_dim: int, width: int, layers: int, skips):
    """B': the trunk backward; in: the bf16 encoding and the f32 upstream
    gradient, out: the encoding's bf16 gradient."""
    return dense_chain_least_ms(npts, trunk_shapes(x_dim, width, layers, skips),
                                4 * x_dim + 4 * width, backward=True)


def field_io_bytes(x_dim: int, d_dim: int, num_classes: int) -> tuple[int, int]:
    """(in, out) bytes per point of the whole field: the bf16 encodings in;
    f32 sigma, rgb and semantic logits out."""
    return 2 * (x_dim + d_dim), 4 * (1 + 3 + num_classes)


def field_fwd_least_ms(npts: int, f: dict):
    """C: the whole field forward (trunk and heads)."""
    x_dim, d_dim = posenc_dim(3, f["xyz_freqs"]), posenc_dim(3, f["dir_freqs"])
    io_in, io_out = field_io_bytes(x_dim, d_dim, f["num_classes"])
    return dense_chain_least_ms(npts, field_shapes(f), io_in + io_out)


def field_bwd_least_ms(npts: int, f: dict):
    """C': the whole field backward; in: the encodings and the outputs'
    gradients, out: the encodings' gradients."""
    x_dim, d_dim = posenc_dim(3, f["xyz_freqs"]), posenc_dim(3, f["dir_freqs"])
    io_in, io_out = field_io_bytes(x_dim, d_dim, f["num_classes"])
    return dense_chain_least_ms(npts, field_shapes(f), 2 * io_in + io_out, backward=True)


def intersect_io_bytes(g: int, m: int, p: int, f: int, k: int) -> int:
    """Bytes A1 / A2 read and write, each once: G groups of M rays (f32
    origin and direction), each group's table of P primitives (f32 affine
    map, int32 labels, bool valid, F f32 cut planes) and the (G, M, K)
    intervals (f32 entry and exit, int32 labels, bool mask)."""
    return g * (m * 2 * 3 * 4 + p * (12 * 4 + 4 + 4 + 1 + f * 4 * 4) + m * k * (4 + 4 + 4 + 4 + 1))


def intersect_least_ms(g: int, m: int, p: int, p_valid: int, f: int, k: int):
    """A1 (G = 1) / A2: the slab tests of every ray against its table's
    valid primitives and their cut planes at the f32 peak, against the
    bytes of `intersect_io_bytes`."""
    return least_ms(g * m * p_valid * (SLAB_OPS + f * PLANE_OPS),
                    intersect_io_bytes(g, m, p, f, k), PEAK_F32)
