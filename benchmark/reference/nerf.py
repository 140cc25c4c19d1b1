"""Plain PyTorch reference of what the benchmark's cells time: the
PanopticNeRF training step (ray batch -> interval intersection -> guided
and inverse-CDF sampling -> coarse and fine fields -> compositing -> the
loss stack -> backward -> Adam with exponential decay) and the full-view
evaluation render (intersection -> the tiled coarse + fine render).

It imports nothing of the program under test and reads its sizes from the
configuration dict of the benchmark's config file (`cfg["program"]`). The
fields follow flax's placement for `model.compute_dtype` bfloat16: every
Dense multiplies in bf16 with its f32 parameters cast down, rounds, then
adds the cast-down bias; sigma, rgb and the semantic logits come out in
f32. `quant` (the control) passes both operands of every product through
a lower-precision format first.

Only the options the benchmark's configurations use are written; any
other value raises, so that the reference never silently computes
something else than the configuration states.

A configuration names its reference module by its file's `reference` key
(`harness/core.reference`). This one is "nerf": its parameters
(`param_shapes`), their seeded draw (`make_weights`) and its field
(`field_apply`). The pipeline around the field (intersection, sampling,
compositing, the losses, Adam, the tiled view) takes the field as an
argument, so a module of another field reuses it with its own field and
draw: `render_view = partial(nerf.render_view, field=its_field)`, and the
same for `Trainer`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

BIG = 1e9
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (amax to 448), as an
    fp8 GEMM takes its operands; returns the value in x's dtype, with the
    gradient of the identity."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x.detach())  # the gradient passes straight through


def check_supported(cfg: dict) -> None:
    """Raise on any option the reference does not compute."""
    d, m, r, lo, t = cfg["data"], cfg["model"], cfg["render"], cfg["loss"], cfg["train"]
    bad = {
        "model.compute_dtype": m["compute_dtype"] != "bfloat16",
        "model.use_viewdirs": not m["use_viewdirs"],
        "model.use_semantic": not m["use_semantic"],
        "render.use_primitives": not r["use_primitives"],
        "render.white_bkgd": r["white_bkgd"],
        "render.raw_noise_std": r["raw_noise_std"] > 0,
        "render.eval_keep_samples": r["eval_keep_samples"] > 0,
        "render.n_importance": r["n_importance"] <= 0,
        "data.views_per_batch": d["views_per_batch"] <= 0,
        "data.use_fisheye": d.get("use_fisheye", False),
        "loss.rel_filter": lo["rel_filter_ratio"] > 0 or lo["rel_filter_total"] > 0,
        "loss.empty_sky_filter": lo["empty_sky_filter"],
        "loss.agree_filter": lo["agree_filter"],
        "loss.weight_th_final": lo["weight_th_final"] >= 0,
        "train.grad_clip": t["grad_clip"] > 0,
        "train.weight_decay": t["weight_decay"] > 0,
        "train.ema_decay": t["ema_decay"] > 0,
    }
    off = [k for k, v in bad.items() if v]
    if off:
        raise ValueError(f"the reference does not compute {off}")


# ----------------------------------------------------------------- fields

def posenc(x: torch.Tensor, n: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{n-1} x), cos(2^{n-1} x)],
    the D sines of a band before its D cosines."""
    freqs = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], -1).reshape(*x.shape[:-1], 2 * n * x.shape[-1])
    return torch.cat([x, enc], -1)


def field_sizes(cfg: dict, level: int) -> dict:
    """Depth, width, skips and colour width of the coarse (0) or fine (1)
    field: the coarse trunk shrinks to model.coarse_trunk_depth / width."""
    m = cfg["model"]
    depth, width, skips, cw = m["trunk_depth"], m["trunk_width"], tuple(m["skips"]), m["color_width"]
    if level == 0 and (m["coarse_trunk_depth"] or m["coarse_trunk_width"]):
        depth = m["coarse_trunk_depth"] or depth
        width = m["coarse_trunk_width"] or width
        skips = tuple(s for s in skips if s < depth - 1)
        cw = min(cw, width)
    return dict(depth=depth, width=width, skips=skips, color_width=cw)


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every parameter, named as torch.nn.Linear names
    them in a module tree coarse.* / fine.* (weights (out, in))."""
    m = cfg["model"]
    x_dim, d_dim = 3 * (2 * m["xyz_freqs"] + 1), 3 * (2 * m["dir_freqs"] + 1)
    out = {}
    for level, prefix in ((0, "coarse"), (1, "fine")):
        s = field_sizes(cfg, level)
        w = s["width"]
        lin = []
        in_dim = x_dim
        for i in range(s["depth"]):
            lin.append((f"trunk_{i}", in_dim, w))
            in_dim = w + x_dim if i in s["skips"] else w
        lin += [("sigma", in_dim, 1), ("sem_hidden", in_dim, w // 2),
                ("sem_out", w // 2, m["num_classes"]), ("feature", in_dim, w),
                ("color_hidden", w + d_dim, s["color_width"]), ("color_out", s["color_width"], 3)]
        for name, i, o in lin:
            out[f"{prefix}.{name}.weight"] = (o, i)
            out[f"{prefix}.{name}.bias"] = (o,)
    return out


def field_apply(params: dict, cfg: dict, level: int, pts: torch.Tensor, dirs: torch.Tensor,
                quant: Optional[Callable] = None):
    """pts (..., 3) scene-normalised, dirs (..., 3) unit and broadcastable
    -> (sigma (...), rgb (..., 3), sem logits (..., C)), all f32."""
    m = cfg["model"]
    s = field_sizes(cfg, level)
    prefix = "coarse" if level == 0 else "fine"
    dt = torch.bfloat16
    q = quant or (lambda a: a)

    def dense(x, name):
        w = params[f"{prefix}.{name}.weight"].to(dt)
        return F.linear(q(x), q(w)) + params[f"{prefix}.{name}.bias"].to(dt)

    x_enc = posenc(pts, m["xyz_freqs"]).to(dt)
    h = x_enc
    for i in range(s["depth"]):
        h = torch.relu(dense(h, f"trunk_{i}"))
        if i in s["skips"]:
            h = torch.cat([h, x_enc], -1)
    sigma = dense(h, "sigma")[..., 0].float()
    sem = dense(torch.relu(dense(h, "sem_hidden")), "sem_out").float()
    feat = dense(h, "feature")
    d_enc = posenc(dirs, m["dir_freqs"]).to(dt).expand(*feat.shape[:-1], -1)
    r = torch.relu(dense(torch.cat([feat, d_enc], -1), "color_hidden"))
    rgb = torch.sigmoid(dense(r, "color_out")).float()
    return sigma, rgb, sem


# ----------------------------------------------------------- intersection

class Intervals(NamedTuple):
    t_in: torch.Tensor      # (N, K)
    t_out: torch.Tensor     # (N, K)
    semantic: torch.Tensor  # (N, K) int, -1 where empty
    instance: torch.Tensor  # (N, K)
    mask: torch.Tensor      # (N, K) bool


def intersect(o: torch.Tensor, d: torch.Tensor, w2p, sem, inst, valid, planes,
              near: float, far: float, k: int) -> Intervals:
    """Rays (N, 3) against one table of P unit-cube primitives (w2p (P, 3,
    4), optional convex cut planes (P, F, 4) n.x <= b in the local frame):
    the slab intervals clipped to [near, far], the K nearest by entry
    (ties: the lower primitive index first)."""
    n, p = o.shape[0], w2p.shape[0]
    t_lo = torch.full((n, p), -BIG, device=o.device)
    t_hi = torch.full((n, p), BIG, device=o.device)
    o_ls, d_ls = [], []
    for i in range(3):
        r0, r1, r2, tr = w2p[:, i, 0], w2p[:, i, 1], w2p[:, i, 2], w2p[:, i, 3]
        o_l = o[:, 0:1] * r0 + o[:, 1:2] * r1 + o[:, 2:3] * r2 + tr
        d_l = d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2
        o_ls.append(o_l)
        d_ls.append(d_l)
        par = d_l.abs() < 1e-9
        inv = 1.0 / torch.where(par, torch.where(d_l >= 0, 1e-9, -1e-9), d_l)
        t1, t2 = (-1.0 - o_l) * inv, (1.0 - o_l) * inv
        out = par & (o_l.abs() > 1.0)
        t_lo = torch.maximum(t_lo, torch.where(out, BIG, torch.minimum(t1, t2)))
        t_hi = torch.minimum(t_hi, torch.where(out, -BIG, torch.maximum(t1, t2)))
    if planes is not None:
        eps = 1e-9
        nx, ny, nz, b = planes[..., 0], planes[..., 1], planes[..., 2], planes[..., 3]
        a = nx * d_ls[0][..., None] + ny * d_ls[1][..., None] + nz * d_ls[2][..., None]
        c = b - (nx * o_ls[0][..., None] + ny * o_ls[1][..., None] + nz * o_ls[2][..., None])
        t_pl = c / torch.where(a.abs() < eps, eps, a)
        t_lo = torch.maximum(t_lo, torch.where(a < -eps, t_pl, -BIG).amax(-1))
        t_hi = torch.minimum(t_hi, torch.where(a > eps, t_pl, BIG).amin(-1))
        t_hi = torch.where(((a.abs() <= eps) & (c < 0)).any(-1), -BIG, t_hi)
    t_in, t_out = t_lo.clamp(min=near), t_hi.clamp(max=far)
    hit = (t_out > t_in) & valid
    t_in, t_out = torch.where(hit, t_in, BIG), torch.where(hit, t_out, BIG)
    ke = min(k, p)
    idx = torch.sort(t_in, dim=-1, stable=True).indices[:, :ke]
    g = lambda a: torch.gather(a, 1, idx)
    h = g(hit)
    s_, i_ = sem.long()[idx], inst.long()[idx]
    ti, to = torch.where(h, g(t_in), BIG), torch.where(h, g(t_out), BIG)
    s_, i_ = torch.where(h, s_, -1), torch.where(h, i_, -1)
    if ke < k:
        pad = lambda a, v: torch.cat([a, a.new_full((n, k - ke), v)], 1)
        ti, to, s_, i_, h = pad(ti, BIG), pad(to, BIG), pad(s_, -1), pad(i_, -1), pad(h, False)
    return Intervals(ti, to, s_, i_, h)


def containment(z: torch.Tensor, iv: Intervals):
    """(inside (N, S, K): z in interval k; inside labelled (N, S, K); the
    count of labelled intervals holding each sample (N, S))."""
    inside = (z[..., None] >= iv.t_in[:, None]) & (z[..., None] <= iv.t_out[:, None]) \
        & iv.mask[:, None]
    lab = inside & (iv.mask & (iv.semantic >= 0))[:, None]
    return inside, lab, lab.sum(-1).float()


# --------------------------------------------------------------- sampling

def _lin01(num: int, device) -> torch.Tensor:
    return torch.arange(num, dtype=torch.float32, device=device) / (num - 1)


def stratified(n: int, s: int, near: float, far: float, u: Optional[torch.Tensor], device):
    t = _lin01(s + 1, device)[:-1]
    frac = t[None] + (u if u is not None else torch.full((n, s), 0.5, device=device)) / s
    return near + (far - near) * frac


def n_split(n_samples: int, bg_frac: float) -> tuple[int, int]:
    s_bg = max(int(round(n_samples * bg_frac)), 1) if bg_frac > 0 else 0
    return n_samples - s_bg, s_bg


def guided(iv: Intervals, s: int, near: float, far: float, bg_frac: float,
           u_in: Optional[torch.Tensor], u_bg: Optional[torch.Tensor]) -> torch.Tensor:
    """S_in depths spread over the union of a ray's intervals by arc length
    (a ray that hits nothing: stratified over [near, far] with the same
    uniforms), merged with S_bg stratified background depths."""
    n, dev = iv.t_in.shape[0], iv.t_in.device
    s_in, s_bg = n_split(s, bg_frac)
    end = torch.where(iv.mask, iv.t_out, -1e9)
    prev = torch.cat([torch.full_like(end[:, :1], -1e9), torch.cummax(end, 1).values[:, :-1]], 1)
    seg_in = torch.maximum(iv.t_in, prev)
    seg_len = torch.where(iv.mask, iv.t_out - seg_in, 0.0).clamp(min=0.0)
    cdf = torch.cumsum(seg_len, -1)
    total = cdf[:, -1:]
    jitter = u_in / s_in if u_in is not None else 0.5 / s_in
    u = (_lin01(s_in + 1, dev)[:-1][None] + jitter) * total
    idx = torch.searchsorted(cdf, u, right=True).clamp(0, seg_len.shape[-1] - 1)
    cdf_prev = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], -1)
    z = torch.gather(seg_in, 1, idx) + (u - torch.gather(cdf_prev, 1, idx))
    z = torch.where((total[:, 0] > 1e-8)[:, None], z, stratified(n, s_in, near, far, u_in, dev))
    if s_bg > 0:
        z = torch.cat([z, stratified(n, s_bg, near, far, u_bg, dev)], 1).sort(dim=1, stable=True).values
    return z


def pdf_samples(bins: torch.Tensor, w: torch.Tensor, m: int, u: Optional[torch.Tensor]):
    """Inverse-CDF depths over the bins' weights (+1e-5 each)."""
    n, b = w.shape
    dev = w.device
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if u is not None:
        uu = _lin01(m + 1, dev)[:-1][None] + u / m
    else:
        uu = _lin01(m + 2, dev)[1:-1][None].expand(n, m).contiguous()
    inds = torch.searchsorted(cdf, uu, right=True)
    lo, hi = (inds - 1).clamp(0, b - 1), inds.clamp(1, b)
    c_lo, c_hi = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    z_lo, z_hi = torch.gather(bins, 1, lo), torch.gather(bins, 1, hi)
    den = torch.where(c_hi - c_lo < 1e-5, 1.0, c_hi - c_lo)
    return z_lo + (uu - c_lo) / den * (z_hi - z_lo)


# ------------------------------------------------------------- rendering

class Level(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    weights: torch.Tensor
    sem: torch.Tensor          # composited learned logits (N, C)
    fixed: torch.Tensor        # composited fixed distribution (N, C)
    inst_mass: torch.Tensor    # (N, K)
    sample_sem: torch.Tensor   # (N, S, C)
    inside_lab: torch.Tensor   # (N, S, K)
    cnt: torch.Tensor          # (N, S)


def render_level(params, cfg, level, o, d, z, center, scale, iv: Intervals, quant=None,
                 field: Callable = field_apply) -> Level:
    pts = ((o[:, None] + d[:, None] * z[..., None]) - center) * scale
    sigma, rgb, sem = field(params, cfg, level, pts, d[:, None], quant)
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    tau = torch.logaddexp(sigma, torch.zeros_like(sigma)) * delta
    alpha = 1.0 - torch.exp(-tau)
    log_t = -torch.cumsum(tau, -1)
    w = alpha * torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]), log_t[:, :-1]], -1))
    inside, lab, cnt = containment(z, iv)
    wsum = lambda f: torch.sum(w[..., None] * f, 1)
    nc = cfg["model"]["num_classes"]
    mass = torch.sum((w / cnt.clamp(min=1.0))[..., None] * lab.float(), 1)      # (N, K)
    onehot = F.one_hot(iv.semantic.clamp(0, nc - 1), nc).float() \
        * (iv.mask & (iv.semantic >= 0))[..., None]
    fixed = torch.sum(mass[..., None] * onehot, 1)
    return Level(wsum(rgb), torch.sum(w * z, -1), w, wsum(sem), fixed, wsum(inside.float()),
                 sem, lab, cnt)


def render(params, cfg, o, d, iv, center, scale, draws: Optional[dict], quant=None,
           field: Callable = field_apply):
    """Coarse then fine render of rays (N, 3) through `field`, which takes
    `field_apply`'s arguments. `draws` (training): the uniforms "coarse",
    "bg", "fine"; None renders deterministically."""
    r = cfg["render"]
    dr = draws or {}
    z = guided(iv, r["n_samples"], r["near"], r["far"], r["bg_sample_frac"],
               dr.get("coarse"), dr.get("bg"))
    coarse = render_level(params, cfg, 0, o, d, z, center, scale, iv, quant, field)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_f = pdf_samples(z_mid, coarse.weights[:, 1:-1].detach(), r["n_importance"], dr.get("fine"))
    z_all = torch.cat([z, z_f], 1).sort(dim=1, stable=True).values
    fine = render_level(params, cfg, 1, o, d, z_all, center, scale, iv, quant, field)
    return coarse, fine


# ------------------------------------------------------------- training

def batch_rays(scene: dict, view_ids: torch.Tensor, draws: dict, n: int, g: int):
    """The ray batch of one step's draws: G views (positions in
    `view_ids`), N / G pixels of each; rays through pixel centres."""
    vi = torch.repeat_interleave(view_ids.long()[draws["group"].long()], n // g)
    u, v = draws["u"].long(), draws["v"].long()
    K, c2w = scene["K"][vi], scene["c2w"][vi]
    uv = torch.stack([u, v], -1).float() + 0.5
    dirs = torch.stack([(uv[:, 0] - K[:, 0, 2]) / K[:, 0, 0], (uv[:, 1] - K[:, 1, 2]) / K[:, 1, 1],
                        torch.ones(n, device=uv.device)], -1)
    dw = torch.sum(c2w[:, :, :3] * dirs[:, None], -1)
    dw = dw / torch.linalg.vector_norm(dw, dim=-1, keepdim=True)
    valid = scene["valid_mask"][vi, v, u] if scene.get("valid_mask") is not None \
        else torch.ones(n, dtype=torch.bool, device=uv.device)
    return dict(o=c2w[:, :, 3].contiguous(), d=dw, view=vi,
                rgb=scene["images"][vi, v, u].float() / 255.0,
                pseudo=scene["pseudo"][vi, v, u], depth=scene["depth"][vi, v, u], valid=valid)


def batch_intervals(scene: dict, b: dict, cfg: dict) -> Intervals:
    d, r = cfg["data"], cfg["render"]
    n, g = b["o"].shape[0], d["views_per_batch"]
    m = n // g
    parts = []
    for gi in range(g):
        v = int(b["view"][gi * m])
        planes = scene["prim_planes"][v] if scene.get("prim_planes") is not None else None
        parts.append(intersect(b["o"][gi * m:(gi + 1) * m], b["d"][gi * m:(gi + 1) * m],
                               scene["prim_w2p"][v], scene["prim_sem"][v], scene["prim_inst"][v],
                               scene["prim_valid"][v], planes, r["near"], r["far"],
                               d["max_intervals"]))
    return Intervals(*[torch.cat(x) for x in zip(*parts)])


def _ce_probs(p: torch.Tensor, lab: torch.Tensor, eps: float = 1e-6):
    p = p / p.sum(-1, keepdim=True).clamp(min=eps)
    sel = torch.gather(p, -1, lab.clamp(0, p.shape[-1] - 1).long()[..., None])[..., 0]
    return -torch.log(sel.clamp(min=eps))


def losses(coarse: Level, fine: Level, b: dict, iv: Intervals, cfg: dict, sem_on: bool):
    """The loss stack: rgb and depth (fine + coarse), the fixed-field 2D CE
    and the learned 2D CE against the consistency-filtered pseudo-labels,
    the per-sample 3D CE inside labelled primitives; masked means."""
    lo, nc = cfg["loss"], cfg["model"]["num_classes"]
    ok = b["valid"].float()
    mmean = lambda x, m: torch.sum(x * m) / m.sum().clamp(min=1.0)
    l_rgb = mmean(((fine.rgb - b["rgb"]) ** 2).mean(-1), ok) \
        + mmean(((coarse.rgb - b["rgb"]) ** 2).mean(-1), ok)
    total = lo["rgb_weight"] * l_rgb
    if lo["depth_weight"] > 0:
        dm = ((b["depth"] > 0) & b["valid"]).float()
        l_d = mmean((fine.depth - b["depth"]).abs(), dm) + mmean((coarse.depth - b["depth"]).abs(), dm)
        total = total + lo["depth_weight"] * l_d
    scale = 1.0 if sem_on else 0.0
    has = (b["pseudo"] != 255) & b["valid"]
    lab = b["pseudo"].clamp(0, nc - 1).long()
    fm = fine.fixed
    has_prims = fm.sum(-1) > 1e-6
    if lo["pseudo_filter"]:
        keep = has & ((torch.gather(fm, -1, lab[:, None])[:, 0] > lo["weight_th"]) | ~has_prims)
    else:
        keep = has
    if lo["fix2d_weight"] > 0:
        fk = has & has_prims & (keep if lo["filter_fix2d"] else True)
        total = total + scale * lo["fix2d_weight"] * mmean(_ce_probs(fm, b["pseudo"]), fk.float())
    if lo["sem2d_weight"] > 0:
        ce = -torch.gather(torch.log_softmax(fine.sem, -1), -1, lab[:, None])[:, 0]
        total = total + scale * lo["sem2d_weight"] * mmean(ce, keep.float())
    if lo["sem3d_weight"] > 0:
        onehot = F.one_hot(iv.semantic.clamp(0, nc - 1), nc).float() * (iv.semantic >= 0)[..., None]
        target = torch.bmm(fine.inside_lab.float(), onehot) / fine.cnt.clamp(min=1.0)[..., None]
        ce3 = -torch.sum(target * torch.log_softmax(fine.sample_sem, -1), -1)
        total = total + scale * lo["sem3d_weight"] * mmean(ce3, (fine.cnt > 0).float())
    return total


def lr_at(cfg: dict, t: int) -> float:
    tc = cfg["train"]
    rate = tc["lr_decay_rate"] if tc["lr_decay_rate"] > 0 else 1.0
    return tc["lr"] * rate ** (t / max(tc["max_steps"], 1))


class Trainer:
    """The reference training loop through `field` from given f32
    parameters at step `start` (which sets the learning rate and the
    semantic gate), with a fresh Adam (its bias correction counts from 1)."""

    def __init__(self, cfg: dict, params: dict, start: int, quant=None,
                 field: Callable = field_apply):
        check_supported(cfg)
        self.cfg, self.t, self.quant, self.field = cfg, start, quant, field
        self.params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.first_grads = None

    def step(self, scene: dict, view_ids: torch.Tensor, draws: dict, n_rays: Optional[int] = None):
        """One step on the draws; `n_rays` < the config's renders only the
        batch's first rays (the half-batch fault). Returns the loss (float)."""
        c, d = self.cfg, self.cfg["data"]
        n, g = d["n_rays"], d["views_per_batch"]
        b = batch_rays(scene, view_ids, draws, n, g)
        iv = batch_intervals(scene, b, c)
        u = {k: draws.get(k) for k in ("coarse", "bg", "fine")}
        if n_rays is not None:
            cut = lambda x: None if x is None else x[:n_rays]
            b = {k: cut(v) for k, v in b.items()}
            iv = Intervals(*[cut(x) for x in iv])
            u = {k: cut(v) for k, v in u.items()}
        tr = c["train"]
        sem_on = not (tr["pretrain"] == "nerf" and self.t < tr["pretrain_steps"])
        coarse, fine = render(self.params, c, b["o"], b["d"], iv, scene["bounds_center"],
                              scene["bounds_scale"], u, self.quant, self.field)
        loss = losses(coarse, fine, b, iv, c, sem_on)
        grads = torch.autograd.grad(loss, list(self.params.values()), allow_unused=True)
        lr = lr_at(c, self.t)
        self.count += 1
        with torch.no_grad():
            gd = {}
            for (k, p), gr in zip(self.params.items(), grads):
                gr = torch.zeros_like(p) if gr is None else gr
                gd[k] = gr
                self.m[k].mul_(ADAM_B1).add_(gr, alpha=1 - ADAM_B1)
                self.v[k].mul_(ADAM_B2).addcmul_(gr, gr, value=1 - ADAM_B2)
                m_hat = self.m[k] / (1 - ADAM_B1 ** self.count)
                v_hat = self.v[k] / (1 - ADAM_B2 ** self.count)
                p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
            if self.first_grads is None:
                self.first_grads = gd
        self.t += 1
        return float(loss.detach())


# ------------------------------------------------------------ evaluation

def view_rays(scene: dict, view: int):
    h, w = scene["images"].shape[1:3]
    dev = scene["images"].device
    vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1).float() + 0.5
    K, c2w = scene["K"][view], scene["c2w"][view]
    dirs = torch.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1],
                        torch.ones(uv.shape[0], device=dev)], -1)
    d = dirs @ c2w[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(c2w[:, 3], d.shape).contiguous(), d


@torch.no_grad()
def render_view(params: dict, cfg: dict, scene: dict, view: int, quant=None,
                tile: int = 8192, field: Callable = field_apply) -> dict:
    """One whole view through `field`, deterministic (no jitter), in tiles
    of `tile` rays: rgb (N, 3), depth (N,), the composited learned semantic
    logits (N, C)."""
    check_supported(cfg)
    r, d = cfg["render"], cfg["data"]
    ev = dict(cfg, render=dict(r, n_samples=r["eval_n_samples"] or r["n_samples"],
                               n_importance=(r["eval_n_importance"] if r["eval_n_importance"] >= 0
                                             else r["n_importance"])))
    o, dd = view_rays(scene, view)
    planes = scene["prim_planes"][view] if scene.get("prim_planes") is not None else None
    out = {"rgb": [], "depth": [], "sem_logits": []}
    for s in range(0, o.shape[0], tile):
        ot, dt_ = o[s:s + tile], dd[s:s + tile]
        iv = intersect(ot, dt_, scene["prim_w2p"][view], scene["prim_sem"][view],
                       scene["prim_inst"][view], scene["prim_valid"][view], planes,
                       r["near"], r["far"], d["max_intervals"])
        _, fine = render(params, ev, ot, dt_, iv, scene["bounds_center"], scene["bounds_scale"],
                         None, quant, field)
        out["rgb"].append(fine.rgb)
        out["depth"].append(fine.depth)
        out["sem_logits"].append(fine.sem)
    return {k: torch.cat(v) for k, v in out.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """Worst leaf of |norm(prog leaf) - norm(ref leaf)| over the larger of
    the reference leaf's norm and the median reference leaf's norm ->
    (gap, leaf name). `keep`: the leaves compared (default all)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    worst, leaf = 0.0, ""
    for k in names:
        pn = float(torch.linalg.vector_norm(prog[k].float()))
        gap = abs(pn - rn[k]) / max(rn[k], med, 1e-30)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def quiet_leaves(grads: dict, frac: float = 1e-3) -> set:
    """Leaves whose reference gradient norm is under `frac` of the median
    leaf's: nought to rounding, so Adam moves them by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.float())) for k, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k for k, v in norms.items() if v < frac * med}


def std_normal_trunc(u: torch.Tensor) -> torch.Tensor:
    """A normal truncated at +-2 from uniforms in (0, 1), by its inverse CDF."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    return math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)


def make_weights(conf_program: dict, seed: int, device) -> dict:
    """Every parameter of both fields, f32 on `device`, in one draw: each
    weight from a normal truncated at +-2 scaled to variance 1 / fan_in
    (flax Dense's lecun normal), every bias 0."""
    shapes = param_shapes(conf_program)
    weights = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    total = sum(o * i for o, i in weights.values())
    g = torch.Generator(device).manual_seed(seed)
    flat = std_normal_trunc(torch.rand(total, generator=g, device=device).clamp(1e-7, 1 - 1e-7))
    out, at = {}, 0
    for k, s in shapes.items():
        if k.endswith(".weight"):
            o, i = s
            out[k] = flat[at:at + o * i].view(o, i) * (1.0 / math.sqrt(i) / 0.87962566103423978)
            at += o * i
        else:
            out[k] = torch.zeros(s, device=device)
    return out
