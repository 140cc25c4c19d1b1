"""Typed dataclass config tree with YAML + CLI overrides.

The same schema as `panopticnerf_tpu/config/config.py` (field for field,
default for default — `tests/test_torch_package.py` pins it), so both
packages read the same `configs/*.yaml` and take the same flat `KEY VALUE`
overrides. It is a copy rather than an import because this package imports
nothing of the JAX package. The field comments live in the reference
schema; the ones here say only what the port does with a field.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Tuple

import yaml


@dataclass
class DataConfig:
    dataset: str = "synthetic"  # the port builds "synthetic" only so far
    root: str = "datasets/KITTI-360"
    sequence: str = "2013_05_28_drive_0000_sync"
    sequences: Tuple[str, ...] = ()
    frame_start: int = 0
    frame_num: int = 64
    frame_step: int = 1
    ratio: float = 1.0
    use_stereo: bool = True
    use_fisheye: bool = False
    use_pspnet: bool = True
    use_depth: bool = True
    depth_convention: str = "plane_z"
    pseudo_clean_neighbors: int = 0
    pseudo_cross_view: int = 0
    pseudo_xview_tol: float = 0.1
    pseudo_xview_min_voters: int = 2
    pseudo_xview_mode: str = "splat"
    pseudo_xview_repaint: float = 0.0
    n_rays: int = 2048
    views_per_batch: int = 8
    max_primitives: int = 64       # P primitives per view
    max_intervals: int = 16        # K intervals kept per ray
    max_cut_planes: int = 8
    test_every: int = 8
    stream_window: int = 0
    stream_refresh_steps: int = 500
    synthetic_num_boxes: int = 8
    synthetic_image_hw: Tuple[int, int] = (64, 96)
    synthetic_num_frames: int = 12
    synthetic_ground: bool = False
    synthetic_fisheye: bool = False
    synthetic_sky_noise: float = 0.0


@dataclass
class ModelConfig:
    xyz_freqs: int = 10
    dir_freqs: int = 4
    trunk_depth: int = 8
    trunk_width: int = 256
    skips: Tuple[int, ...] = (4,)
    color_width: int = 128
    num_classes: int = 45
    use_semantic: bool = True
    use_viewdirs: bool = True
    compute_dtype: str = "bfloat16"  # matmul dtype; parameters stay float32
    use_pallas: bool = False         # train step only; the render never reads it
    pallas_mode: str = "trunk"
    coarse_trunk_depth: int = 0
    coarse_trunk_width: int = 0


@dataclass
class RenderConfig:
    n_samples: int = 64
    n_importance: int = 0
    perturb: bool = True
    near: float = 0.1
    far: float = 100.0
    white_bkgd: bool = False
    use_primitives: bool = False
    bg_sample_frac: float = 0.25
    eval_n_samples: int = 0
    eval_n_importance: int = -1
    eval_keep_samples: int = 0
    ray_tile: int = 4096             # rays per tile of the full-image render
    # The port always intersects with its kernel on a CUDA device (and with
    # the kernel's plain version on the CPU); the key is kept for the schema.
    use_pallas_intersect: bool = False
    raw_noise_std: float = 0.0


@dataclass
class LossConfig:
    rgb_weight: float = 1.0
    sem2d_weight: float = 0.2
    fix2d_weight: float = 0.2
    sem3d_weight: float = 0.1
    depth_weight: float = 0.1
    pseudo_filter: bool = True
    weight_th: float = 0.05
    rel_filter_ratio: float = 0.0
    rel_filter_total: float = 0.0
    empty_sky_filter: bool = False
    empty_sky_weight: float = 0.0
    filter_fix2d: bool = True
    eval_fixed_blend: float = 0.5    # learned/fixed blend of the panoptic fusion
    agree_filter: bool = False
    agree_conf: float = 0.9
    agree_start: float = 0.5
    weight_th_final: float = -1.0
    weight_th_anneal_start: float = 0.5


@dataclass
class TrainConfig:
    lr: float = 5e-4
    lr_decay_rate: float = 0.1
    max_steps: int = 200_000
    ep_iter: int = 500
    epochs: int = 400
    grad_clip: float = 0.0
    weight_decay: float = 0.0
    save_ep: int = 20
    eval_ep: int = 20
    log_interval: int = 20
    record_interval: int = 100
    resume: bool = True
    pretrain: str = ""
    pretrain_steps: int = 20_000
    init_from: str = ""
    eval_step: int = 0               # checkpoint step to evaluate (0 = latest)
    save_best: bool = True
    eval_views: int = 8
    ema_decay: float = 0.0
    seed: int = 0                    # also seeds the synthetic scene


@dataclass
class ParallelConfig:
    data_parallel: int = 0
    mesh_axis_name: str = "data"
    kernel_shard_map: bool = True


@dataclass
class EvalConfig:
    lpips_weights: str = ""          # LPIPS is not ported yet: must stay empty
    fusion_rule: str = "match"       # "match" | "raw"
    sky_rule: str = "off"            # "off" | "empty" | "support" | "soft[:w]"
    sky_class: int = -1
    sky_eps: float = 1e-4


@dataclass
class Config:
    task: str = "panopticnerf"
    exp_name: str = "default"
    model_dir: str = "out/trained_model"
    record_dir: str = "out/record"
    result_dir: str = "out/result"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    @property
    def trained_model_dir(self) -> str:
        return os.path.join(self.model_dir, self.task, self.exp_name)

    @property
    def best_model_dir(self) -> str:
        """Metric-selected checkpoint root (train.save_best), a sibling of
        the step root."""
        return os.path.join(self.model_dir, self.task, self.exp_name + "_best")

    @property
    def best_metric_path(self) -> str:
        return os.path.join(self.model_dir, self.task, self.exp_name + "_best_metric.json")

    @property
    def record_path(self) -> str:
        return os.path.join(self.record_dir, self.task, self.exp_name)

    @property
    def result_path(self) -> str:
        return os.path.join(self.result_dir, self.task, self.exp_name)


# Reference-style flat CLI keys -> dotted paths (the same table as the
# reference schema's).
_ALIASES = {
    "exp_name": "exp_name",
    "task": "task",
    "use_stereo": "data.use_stereo",
    "use_fisheye": "data.use_fisheye",
    "use_pspnet": "data.use_pspnet",
    "use_depth": "data.use_depth",
    "pseudo_filter": "loss.pseudo_filter",
    "weight_th": "loss.weight_th",
    "pretrain": "train.pretrain",
    "resume": "train.resume",
    "gpus": None,  # accepted and ignored
    "N_rays": "data.n_rays",
    "N_samples": "render.n_samples",
    "N_importance": "render.n_importance",
    "chunk": "render.ray_tile",
    "lr": "train.lr",
    "ratio": "data.ratio",
}


def _coerce(value: Any, ty: Any) -> Any:
    """Coerce a YAML/CLI value to the declared dataclass field type."""
    if ty is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("true", "1", "yes", "on"):
            return True
        if s in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if ty is int:
        return int(value)
    if ty is float:
        return float(value)
    if ty is str:
        return str(value)
    origin = getattr(ty, "__origin__", None)
    if origin in (tuple, list):
        args = getattr(ty, "__args__", ())
        elem = args[0] if args else str
        if isinstance(value, str):
            for ch in ",()[]":
                value = value.replace(ch, " ")
            value = [v for v in value.split() if v]
        out = tuple(_coerce(v, elem) for v in value)
        return out if origin is tuple else list(out)
    return value


def _field_type(obj: Any, name: str) -> Any:
    if not any(f.name == name for f in fields(obj)):
        raise KeyError(f"unknown config key {name!r} in {type(obj).__name__}")
    return typing.get_type_hints(type(obj))[name]


def _set_dotted(cfg: Any, dotted: str, value: Any) -> None:
    *path, name = dotted.split(".")
    obj = cfg
    for p in path:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config section {p!r} in {dotted!r}")
        obj = getattr(obj, p)
    setattr(obj, name, _coerce(value, _field_type(obj, name)))


def _merge_dict(cfg: Any, d: dict) -> None:
    for k, v in d.items():
        if isinstance(v, dict) and is_dataclass(getattr(cfg, k, None)):
            _merge_dict(getattr(cfg, k), v)
        else:
            setattr(cfg, k, _coerce(v, _field_type(cfg, k)))


def merge_from_file(cfg: Config, path: str) -> Config:
    with open(path) as f:
        _merge_dict(cfg, yaml.safe_load(f) or {})
    return cfg


def merge_from_list(cfg: Config, opts: list) -> Config:
    """`KEY VALUE KEY VALUE ...` overrides; KEY may be dotted or an alias."""
    if len(opts) % 2 != 0:
        raise ValueError(f"override list must be KEY VALUE pairs, got {opts!r}")
    for key, value in zip(opts[0::2], opts[1::2]):
        dotted = _ALIASES.get(key, key)
        if dotted is not None:
            _set_dotted(cfg, dotted, value)
    return cfg


def load_config(cfg_file: str | None = None, opts: list | None = None) -> Config:
    cfg = Config()
    if cfg_file:
        merge_from_file(cfg, cfg_file)
    if opts:
        merge_from_list(cfg, opts)
    return cfg


def make_cfg(args: Any) -> Config:
    """argparse namespace with .cfg_file and .opts -> Config."""
    return load_config(getattr(args, "cfg_file", None), getattr(args, "opts", None))


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
