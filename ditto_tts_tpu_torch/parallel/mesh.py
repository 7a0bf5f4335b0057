"""The (data, model) mesh over ``torch.distributed`` process groups (the JAX
package's ``parallel/mesh.py``).

A ``Mesh`` holds this rank's two groups: the data group (the ranks with its
model index, over which gradients average) and the model group (the ranks
with its data index, over which a tensor-parallel layer's shares sum). The
model axis is innermost, as JAX's ``reshape(data, model)`` of the device
list: rank = d * model + m. The groups are plain ``dist.new_group`` groups,
not DTensor meshes: kernel A's ``autograd.Function`` works on raw pointers
and must see plain local tensors (``parallel/tp.py`` adds the collectives).

``initialize_distributed`` is the twin of ``initialize_multihost``: with
explicit arguments a failure propagates; the zero-argument form reads the
launcher's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
(``python -m torch.distributed.run``) and runs one process when none is
set. One card takes several ranks only under ``gloo``: NCCL refuses two
ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh and its two groups (None
    for a group of one rank, whose collectives are the identity)."""

    data: int
    model: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def size(self, axis: str) -> int:
        return self.data if axis == "data" else self.model

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.model_index

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the axis's group, a new tensor. bf16 and
        fp16 sum in fp32 (gloo stages CUDA tensors through the host, and
        an fp32 sum of the shares rounds once)."""
        if self.size(axis) == 1:
            return t
        buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) \
            else t.clone()
        dist.all_reduce(buf, group=self.data_group if axis == "data"
                        else self.model_group)
        return buf.to(t.dtype)

    def agree(self, value: float, device) -> float:
        """Rank 0's ``value`` on every rank (a broadcast over the world)."""
        if self.data * self.model == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=device)
        dist.broadcast(t, src=0)
        return float(t.item())

    def barrier(self) -> None:
        if self.data * self.model > 1:
            dist.barrier()


def make_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of ``cfg.data x cfg.model`` ranks; the world must hold
    exactly that many (a larger mesh raises, as JAX's raises on too few
    devices). Every rank calls it, in the same order as its other groups."""
    need = cfg.data * cfg.model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need != world:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs {need} "
                         f"processes, the world has {world}")
    if need == 1:
        return Mesh(1, 1, 0)
    rank = dist.get_rank()
    d, m = rank // cfg.model, rank % cfg.model
    model_groups = [dist.new_group([i * cfg.model + j
                                    for j in range(cfg.model)])
                    for i in range(cfg.data)]
    data_groups = [dist.new_group([i * cfg.model + j
                                   for i in range(cfg.data)])
                   for j in range(cfg.model)]
    return Mesh(cfg.data, cfg.model, rank,
                data_group=data_groups[m] if cfg.data > 1 else None,
                model_group=model_groups[d] if cfg.model > 1 else None)


def auto_mesh(model_parallel: int = 1) -> Mesh:
    """The whole world: data = world / model_parallel."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world of {world}")
    return make_mesh(MeshConfig(data=world // model_parallel,
                                model=model_parallel))


def initialize_distributed(backend: str = "nccl",
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           timeout: Optional[float] = None) -> None:
    """Join the process group (idempotent). With any explicit argument a
    failure propagates: a half-initialized run must fail fast, not train
    alone. Without, the launcher's environment is read, and a process it
    did not start (none of ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` set) stays a world of one. ``timeout`` in seconds."""
    if dist.is_initialized():
        return
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not any(k in os.environ for k in _LAUNCHER_ENV):
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kw)


def local_device(device) -> torch.device:
    """This rank's device: ``cuda`` is the launcher's ``LOCAL_RANK``-th
    card modulo the cards present (several ranks share one card under
    gloo), made current; ``cpu`` stays."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def replicated(mesh: Mesh) -> Callable:
    """A replicated tensor is whole on every rank: the identity."""
    return lambda t: t


def batch_sharding(mesh: Mesh) -> Callable:
    """This rank's rows of a batch (the leading axis over "data")."""
    def rows(t):
        n = t.shape[0] // mesh.data
        if n * mesh.data != t.shape[0]:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split "
                             f"over data {mesh.data}")
        return t[mesh.data_index * n:(mesh.data_index + 1) * n]
    return rows
