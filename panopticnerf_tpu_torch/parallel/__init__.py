"""Data parallelism over GPUs: one process per GPU (torchrun), joined by
torch.distributed (port of `panopticnerf_tpu/parallel/`)."""

from panopticnerf_tpu_torch.parallel.distributed import World, maybe_init_distributed
from panopticnerf_tpu_torch.parallel.mesh import resolve_world
from panopticnerf_tpu_torch.parallel.render import render_image_rays_sharded
from panopticnerf_tpu_torch.parallel.step import broadcast_state, make_parallel_train_step

__all__ = [
    "World",
    "broadcast_state",
    "make_parallel_train_step",
    "maybe_init_distributed",
    "render_image_rays_sharded",
    "resolve_world",
]
