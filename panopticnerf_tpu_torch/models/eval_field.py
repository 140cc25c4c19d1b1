"""The evaluation render's field on the card: kernel E (`ops/field_eval.py`)
in place of the plain model, where E takes the field's shape.

`eval_field(model, cfg, device)` is what `render_rays` evaluates when it
renders for evaluation (`train=False`, no gradient): on a CUDA device, for
a `PanopticNeRF` with a bf16 field of a shape E takes at some level, an
`EvalField`; else the model itself. The choice reads the fields' own
configs (`coarse_field_cfg` for a small proposal coarse), no setting of its
own. Each level E does not take runs the plain model. The packed weights
of a field, and E bound to them, are kept while its parameters stay as
they were (`leaves_key`): a view's tiles pack and check
each field once.

A hybrid field (a hash grid beside the MLP, model.hash_grid) runs
kernel G on its tables first, per tile and level (span
`render.grid.<level>` inside the renderer's `render.field.<level>`; counters
`render.grid.points`, the points G encodes, and `render.grid.points_paired`,
those it encodes with lane-paired gathers), and E reads G's features.
"""

from __future__ import annotations

import weakref

import torch

from panopticnerf_tpu_torch.config import ModelConfig
from panopticnerf_tpu_torch.models.nerf import PanopticNeRF, coarse_field_cfg
from panopticnerf_tpu_torch.ops.field_eval import eval_dims, evaluator, grid_evaluator, pack_eval
from panopticnerf_tpu_torch.utils.profiling import count, span

# net -> (leaves_key, device, (evaluator, grid evaluator | None)): the packed field last evaluated
_packed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def leaves_key(net: torch.nn.Module) -> tuple:
    """The state of a module's parameters: their storage and their version
    counters (an in-place update, an optimizer step or a state-dict load
    bumps one), so a packing is reused only while it is current."""
    return tuple((p.data_ptr(), p._version) for p in net.parameters())


def _evaluator(net: torch.nn.Module, dims, device: torch.device):
    key = leaves_key(net)
    hit = _packed.get(net)
    if hit is None or hit[0] != key or hit[1] != device:
        pk = pack_eval(net, dims, torch.bfloat16)
        grid = grid_evaluator(net.grid.tables(), device) if dims.grid_dim else None
        hit = _packed[net] = (key, device, (evaluator(pk, dims, device), grid))
    return hit[2]


class EvalField:
    """Drop-in for `PanopticNeRF` in `render_rays` (called as
    `field(pts, viewdirs, level=...)`, pts (N, S, 3), viewdirs (N, 1, 3)):
    kernel E at the levels in `dims` (after kernel G where the field has a
    hash grid), the model at the others. Counts the points E evaluates
    (`render.field.points_fused`), those G encodes (`render.grid.points`)
    and those it encodes with paired gathers (`render.grid.points_paired`;
    0 where the grid is not G, as on the CPU). Lives for one
    evaluation render, whose weights do not change: each level's packing
    is looked up once."""

    def __init__(self, model: PanopticNeRF, dims: dict):
        self.model = model
        self.dims = dims  # level -> FieldDims
        self._run = {}    # level -> E on the field's packing, bound at its first call

    def _level(self, level: int) -> int:
        return 1 if level == 1 and self.model.has_fine else 0

    def __call__(self, pts: torch.Tensor, viewdirs: torch.Tensor, level: int = 0):
        lv = self._level(level)
        dims = self.dims.get(lv)
        if dims is None:
            return self.model(pts, viewdirs, level=level)
        net = self.model.fine if lv == 1 else self.model.coarse
        n, s = pts.shape[:2]
        count("render.field.points_fused", n * s)
        run = self._run.get(lv)
        if run is None:
            run = self._run[lv] = _evaluator(net, dims, pts.device)
        field, grid_fn = run
        flat = pts.reshape(n * s, 3).contiguous()
        grid = None
        if grid_fn is not None:
            with span(f"render.grid.{('coarse', 'fine')[lv]}"):
                count("render.grid.points", n * s)
                paired = getattr(grid_fn, "paired", False)
                count("render.grid.points_paired", n * s if paired else 0)
                grid = grid_fn(flat)
        sigma, rgb, sem = field(flat, viewdirs.reshape(n, 3).contiguous(), s, grid)
        return (sigma.reshape(n, s), rgb.reshape(n, s, 3),
                None if sem is None else sem.reshape(n, s, -1))


def eval_field(model, cfg: ModelConfig, device: torch.device):
    """The field `render_rays` evaluates for an evaluation render of
    `model` (config `cfg`, the model's) on `device`: an `EvalField` where
    kernel E runs (see the module docstring), else `model`. An EvalField
    comes back as it is: a full-image render binds one per view, and its
    tiles evaluate through it."""
    if isinstance(model, EvalField):
        return model
    if (torch.device(device).type != "cuda" or torch.is_grad_enabled()
            or not isinstance(model, PanopticNeRF)):
        return model
    levels = {0: coarse_field_cfg(cfg, model.has_fine)}
    if model.has_fine:
        levels[1] = cfg
    dims = {lv: eval_dims(c) for lv, c in levels.items() if c.compute_dtype == "bfloat16"}
    dims = {lv: d for lv, d in dims.items() if d is not None}
    return EvalField(model, dims) if dims else model
