"""Plain PyTorch reference of PanopticNeRF-360's own setting (Fu et al., T-PAMI
2025, arXiv 2309.10815) with its hybrid scene field: both fields 8x256 with
the hash grid of `reference/hybrid.py` beside each trunk, rendered as a
360-degree equirect panorama from a view's camera centre against that view's
primitive table. Its field, its draw, its control and its perspective view
are hybrid's (the contract of `harness/core.reference`); it adds the
panorama's rays and the panorama's render.

It imports nothing of the program under test, and no kernel. The panorama,
from its definition: pixel (v, u) of an (H, W) grid, in row-major order
(index v W + u), looks along azimuth theta = ((u + 0.5) / W) 2 pi - pi and
elevation phi = ((v + 0.5) / H) pi - pi / 2, in the camera's frame with x
right, y down and z forward: d_cam = (cos phi sin theta, sin phi, cos phi cos
theta), so theta = 0 looks along z, theta > 0 to the right, phi > 0 down. The
world ray starts at the camera centre and runs along R d_cam (R the camera's
rotation to the world). The panorama's rays are rendered tile by tile
through nerf's intersection, sampling and compositing with hybrid's field,
deterministically, as `nerf.render_view` renders a perspective view.

Where this departs from PanopticNeRF-360 (whose text and code are not in
this repository's snapshot):
- the grid's sizes (Instant-NGP's for NeRF), its join at the heads' input
  and its cube map are `assumed`, as in `configs/kitti360_grid.json`; the
  tables are drawn in +-1 (hybrid's draw), not Instant-NGP's +-1e-4;
- the panorama's size (512 x 1024 in the cell) and the equirect convention
  above are this repository's (`render/panorama.py` of the program); the
  paper's panorama size is not known here;
- a ray that meets none of the view's primitives (behind or above the
  camera) is sampled stratified over [near, far], as nerf samples any ray
  without an interval: no sky or background model;
- the panorama reads one view's primitive table, as the program's does,
  though a 360-degree panorama sees primitives the view's camera does not.
"""

from __future__ import annotations

import math

import torch

from reference import nerf
from reference.hybrid import (  # noqa: F401 (the contract, and hybrid's field and draw)
    Trainer,
    fp8_quant,
    grid_encode,
    hybrid_field,
    leaf_gap,
    make_weights,
    param_shapes,
    quiet_leaves,
    render_view,
)


def panorama_rays(position: torch.Tensor, rotation: torch.Tensor, h: int, w: int):
    """position (3,), rotation (3, 3) camera to world -> (o, d), each
    (H x W, 3) f32, row-major: the equirect rays of the module docstring."""
    dev = position.device
    u = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    v = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    theta = (u + 0.5) / w * (2.0 * math.pi) - math.pi
    phi = (v + 0.5) / h * math.pi - math.pi / 2.0
    cam = torch.stack([torch.cos(phi) * torch.sin(theta), torch.sin(phi),
                       torch.cos(phi) * torch.cos(theta)], -1)
    r = rotation.float()
    d = cam[:, 0:1] * r[:, 0] + cam[:, 1:2] * r[:, 1] + cam[:, 2:3] * r[:, 2]  # R d_cam, in f32
    return position.float().expand(h * w, 3).contiguous(), d


@torch.no_grad()
def render_panorama(params: dict, cfg: dict, scene: dict, view: int, hw, quant=None,
                    tile: int = 8192) -> dict:
    """The (H, W) = `hw` panorama from `view`'s camera centre and
    orientation, against `view`'s primitive table, deterministic, in tiles
    of `tile` rays: rgb (H W, 3), depth (H W,), the composited learned
    semantic logits (H W, C)."""
    nerf.check_supported(cfg)
    r, d = cfg["render"], cfg["data"]
    ev = dict(cfg, render=dict(r, n_samples=r["eval_n_samples"] or r["n_samples"],
                               n_importance=(r["eval_n_importance"] if r["eval_n_importance"] >= 0
                                             else r["n_importance"])))
    c2w = scene["c2w"][view]
    o, dd = panorama_rays(c2w[:, 3], c2w[:, :3], *hw)
    planes = scene["prim_planes"][view] if scene.get("prim_planes") is not None else None
    out = {"rgb": [], "depth": [], "sem_logits": []}
    for s in range(0, o.shape[0], tile):
        ot, dt_ = o[s:s + tile], dd[s:s + tile]
        iv = nerf.intersect(ot, dt_, scene["prim_w2p"][view], scene["prim_sem"][view],
                            scene["prim_inst"][view], scene["prim_valid"][view], planes,
                            r["near"], r["far"], d["max_intervals"])
        _, fine = nerf.render(params, ev, ot, dt_, iv, scene["bounds_center"],
                              scene["bounds_scale"], None, quant, hybrid_field)
        out["rgb"].append(fine.rgb)
        out["depth"].append(fine.depth)
        out["sem_logits"].append(fine.sem)
    return {k: torch.cat(v) for k, v in out.items()}

