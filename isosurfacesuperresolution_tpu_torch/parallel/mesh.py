"""Device meshes over `torch.distributed`: data-parallel training and
batched multi-camera rendering.

Counterpart of the JAX package's `parallel/mesh.py`.  JAX runs one
program over a `jax.sharding.Mesh` and lets XLA insert the collectives;
here one process drives one device (a rank of the default process group:
nccl for the card, gloo for the CPU), a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks, and the
collectives are written out: a data-parallel step gives each rank its
1/N of the global batch and averages the loss and the gradients with one
all-reduce before the spike guard and the optimizer update, so every
rank takes the same decision and the same update, and the N-way step is
the 1-way step on the whole batch up to the order of float32 sums.  The
volume, like the parameters, is replicated: every rank holds its copy.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_device_type() -> str:
    """"cuda" under nccl, else "cpu" (the default group's backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = "data") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over every rank of the default
    process group (which must hold ``num_devices`` ranks when given)."""
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices needs as many "
                         f"processes; the group has {world}")
    return init_device_mesh(mesh_device_type(), (world,),
                            mesh_dim_names=(axis_name,))


def local_device() -> torch.device:
    """This rank's device: its card under nccl, else the CPU."""
    if mesh_device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_index(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's position in the mesh, row-major over its axes; the
    mesh's size)."""
    coord = mesh.get_coordinate()
    return (int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape))),
            int(np.prod(mesh.shape)))


def shard_batch(mesh: DeviceMesh, batch: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
    """This rank's share of each (B, ...) tensor of a global batch: B cut
    into as many equal parts as the mesh has devices, taken in the mesh's
    row-major order."""
    i, n = shard_index(mesh)
    out = []
    for x in batch:
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} devices")
        b = x.shape[0] // n
        out.append(x[i * b:(i + 1) * b])
    return tuple(out)


def _pack(loss: torch.Tensor, grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([loss.reshape(1).to(grads[0].dtype)]
                     + [g.reshape(-1) for g in grads])


def _unpack(flat: torch.Tensor, loss: torch.Tensor,
            grads: Sequence[torch.Tensor]):
    out, i = [], 1
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return flat[0].to(loss.dtype), out


def make_grad_mean(groups: Sequence[dist.ProcessGroup], world: int
                   ) -> Callable:
    """``reduce(loss, grads) -> (loss, grads)``: the mean over ``world``
    ranks, summed over each group in turn (one all-reduce a group) on one
    flat buffer."""
    def reduce(loss, grads):
        flat = _pack(loss, grads)
        for group in groups:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(world)
        return _unpack(flat, loss, grads)
    return reduce


def wrap_step(train_step: Callable, mesh: DeviceMesh,
              reduce: Callable) -> Callable:
    """``wrapped(state, low, flow, high, accept=None, local=False)``: the
    step on this rank's share of the batch (``local``: the batch is the
    share already, `multihost.process_local_batch`) with ``reduce``."""
    def wrapped(state, low, flow, high, accept: Optional[Callable] = None,
                local: bool = False):
        if not local:
            low, flow, high = shard_batch(mesh, (low, flow, high))
        return train_step(state, low, flow, high, accept=accept,
                          reduce=reduce)
    return wrapped


def make_sharded_train_step(train_step: Callable, mesh: DeviceMesh,
                            axis_name: str = "data") -> Callable:
    """Data parallelism for a plain train step (`train.trainer.
    make_train_step`, `train.trainer_shaded.make_shaded_train_step`):
    each rank runs its share of the global batch and one all-reduce
    averages the loss and the gradients before the guard and the
    update."""
    group = mesh.get_group(axis_name)
    return wrap_step(train_step, mesh,
                     make_grad_mean([group], dist.get_world_size(group)))


def render_cameras_sharded(grid, eyes: torch.Tensor, look_ats: torch.Tensor,
                           ups: torch.Tensor, render_cfg, mesh: DeviceMesh,
                           fov_y_degrees: float = 45.0,
                           axis_name: str = "data") -> torch.Tensor:
    """Render N cameras, each rank its N/D of them through
    `render.api.render_frame_gbuffer` on its copy of ``grid``, and gather
    them -> (N, H, W, 12) on every rank."""
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    group = mesh.get_group(axis_name)
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    n = eyes.shape[0]
    if n % d:
        raise ValueError(f"{n} cameras do not split over {d} devices")
    per = n // d
    frames = [render_frame_gbuffer(grid, cam, cam, render_cfg)
              for cam in (CameraParams.create(eyes[i], look_ats[i], ups[i],
                                              fov_y_degrees)
                          for i in range(rank * per, (rank + 1) * per))]
    local = torch.stack(frames)
    parts = [torch.empty_like(local) for _ in range(d)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)
