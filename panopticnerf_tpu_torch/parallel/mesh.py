"""The data-parallel world of a run (port of `panopticnerf_tpu/parallel/mesh.py`).

The JAX package builds a 1-D ("data",) device mesh inside one process;
the port runs one process per GPU, so its "mesh" is the torch.distributed
world: parameters, optimizer state and the EMA replicated on every rank,
the ray batch split along its ray axis. `parallel.data_parallel` 0 means
the world's size; any other value must equal it. `parallel.mesh_axis_name`
and `parallel.kernel_shard_map` choose between TPU routes and are accepted
and unused: every rank runs the CUDA kernels on its own rays.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.parallel.distributed import World, single_world


def resolve_world(cfg: Config, device, world: Optional[World] = None) -> World:
    """The world an entry point runs in: `world` (from
    `maybe_init_distributed`), or a single process on `device`. Raises
    ValueError, on every rank alike, where `parallel.data_parallel` asks for
    another world size than the one launched."""
    if world is None:
        if dist.is_available() and dist.is_initialized():
            raise ValueError("torch.distributed is initialised: pass the World that "
                             "maybe_init_distributed returned")
        world = single_world(device)
    elif world.device != torch.device(device):
        raise ValueError(f"device {device} is not the world's device {world.device}")
    want = cfg.parallel.data_parallel
    if want > 1 and not world.distributed:
        raise ValueError(
            f"parallel.data_parallel={want} needs {want} processes: launch with "
            f"`torchrun --nproc_per_node {want} -m panopticnerf_tpu_torch.train_net ...`")
    if want not in (0, world.size) and world.distributed:
        raise ValueError(f"parallel.data_parallel={want} but the launched world has "
                         f"{world.size} processes (0 follows the world)")
    return world
