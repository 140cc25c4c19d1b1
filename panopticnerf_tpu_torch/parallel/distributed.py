"""Multi-process initialisation and the collectives of data parallelism
(port of `panopticnerf_tpu/parallel/distributed.py`).

One process per GPU, launched by `torchrun`, joined by `torch.distributed`:

    torchrun --nproc_per_node N -m panopticnerf_tpu_torch.train_net --cfg_file ...

`maybe_init_distributed()` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and returns a `World`: the rank, the
world size, the rank's device (`cuda:LOCAL_RANK` for `--device cuda`) and
two process groups, the data group (NCCL on CUDA, gloo on the CPU) that
carries the gradients, the loss denominators and the rendered maps, and a
small gloo group for host-side flags (the agreed SIGTERM) and barriers.
Without that environment it initialises nothing and returns a world of
one process, which is not distributed.

SPMD contract: every rank feeds the same replicated inputs (config, seed,
dataset) and draws the same global random numbers; ranks differ only in
the slice of rays they render. A rank that raises before a collective
leaves the others waiting until the group's timeout, which is finite.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class World:
    """The processes of one run. `group` is None for a single process that
    was not launched distributed; then every collective below is an error,
    and callers take the single-process path instead."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None        # the data group (the default group)
    host_group: Optional[object] = None   # gloo, for host flags and barriers

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def lead(self) -> bool:
        """Rank 0 owns the console, the recorder and every file written."""
        return self.rank == 0

    def _apply(self, t: torch.Tensor, fn) -> torch.Tensor:
        """Run the collective `fn(tensor, group)` on `t` in place. CUDA
        tensors go through NCCL; under gloo, and for CPU tensors, through a
        host copy on a gloo group (gloo's CUDA support varies by
        collective)."""
        if not self.distributed:
            raise RuntimeError("a collective on a world that is not distributed")
        if t.is_cuda and self.backend == "nccl":
            fn(t, self.group)
            return t
        host = t.cpu() if t.is_cuda else t
        fn(host, self.group if self.backend == "gloo" else self.host_group)
        if host is not t:
            t.copy_(host)
        return t

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce (SUM by default); never differentiable."""
        return self._apply(t, lambda x, g: dist.all_reduce(x, op=op, group=g))

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        return self._apply(t, lambda x, g: dist.broadcast(x, src=src, group=g))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, ...) on every rank -> (size, n, ...), rank r's block at [r]."""
        if not self.distributed:
            raise RuntimeError("a collective on a world that is not distributed")
        t = t.contiguous()
        if t.is_cuda and self.backend == "nccl":
            out = t.new_empty((self.size,) + tuple(t.shape))
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host, group=self.group if self.backend == "gloo"
                        else self.host_group)
        return torch.stack(parts).to(t.device)

    def agree(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any (MAX over the host
        group): a decision that must be the same everywhere."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def close(self) -> None:
        """Destroy the process groups (a no-op for a single process)."""
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()


def single_world(device) -> World:
    return World(rank=0, size=1, device=torch.device(device))


def _rank_device(device, local_rank: int) -> torch.device:
    """`cuda` without an index is the rank's own card, cuda:LOCAL_RANK; an
    explicit index (two gloo ranks sharing one card) and `cpu` stay."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def maybe_init_distributed(device="cuda", backend: Optional[str] = None,
                           init_method: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Join the process group that torchrun's environment (or the explicit
    `init_method`, `rank` and `world_size`) describes -> World.

    Without RANK / WORLD_SIZE in the environment and no `init_method`,
    nothing is initialised: a single-process World on `device`. `backend`
    defaults to NCCL for a CUDA device and gloo for the CPU; `init_method`
    to `env://` (MASTER_ADDR, MASTER_PORT). Every collective times out
    after `timeout_s`.
    """
    if init_method is None and "RANK" not in os.environ:
        return single_world(device)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised: pass its World along")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timeout)
    host = dist.new_group(backend="gloo", timeout=timeout)
    return World(rank=rank, size=world_size, device=dev, backend=backend,
                 group=dist.group.WORLD, host_group=host)
