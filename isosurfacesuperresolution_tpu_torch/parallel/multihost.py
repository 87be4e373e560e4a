"""Several hosts: process-group set-up, ("dcn", "ici") hybrid meshes,
hierarchical data parallelism, per-process data feeding.

Counterpart of the JAX package's `parallel/multihost.py`.  The outer mesh
axis ("dcn") spans hosts, the inner ("ici") the devices of a host; a
hybrid step sums the gradients over "ici" first and then over "dcn",
which gives the flat all-reduce's mean up to the order of the sums.
Single-process everything degrades as in JAX: `initialize_distributed`
is a no-op and returns (0, 1).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from isosurfacesuperresolution_tpu_torch.parallel.mesh import (
    local_device, make_grad_mean, mesh_device_type, wrap_step)

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def backend_for(device: torch.device) -> str:
    """The process group's backend for a device: nccl for the card, gloo
    for the CPU (nothing else, and no fallback between them)."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[torch.device] = None
                           ) -> Tuple[int, int]:
    """Join the default process group, as torchrun sets it up.

    Arguments default to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``tcp://`` address, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``); ``device`` (default: the card) picks the backend,
    and on the card the process drives ``cuda:<LOCAL_RANK>``.  With one
    process this is a no-op.  Returns ``(rank, world size)``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    num = (num_processes if num_processes is not None
           else int(os.environ.get("WORLD_SIZE", "1")))
    if num <= 1:
        return 0, 1
    pid = (process_id if process_id is not None
           else int(os.environ["RANK"]))
    if coordinator_address is None:
        coordinator_address = (f"tcp://{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    device = torch.device("cuda" if device is None else device)
    kwargs = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", pid))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend_for(device),
                            init_method=coordinator_address,
                            world_size=num, rank=pid, **kwargs)
    return pid, num


def make_hybrid_mesh(num_dcn: Optional[int] = None,
                     axis_names: Tuple[str, str] = (DCN_AXIS, ICI_AXIS)
                     ) -> DeviceMesh:
    """A 2-D ``(dcn, ici)`` mesh over the default group's ranks, rank r
    at (r // per, r % per): the outer axis across hosts (by default the
    world size over torchrun's ``LOCAL_WORLD_SIZE``), the inner across
    the devices of a host."""
    world = dist.get_world_size()
    if num_dcn is None:
        num_dcn = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % num_dcn:
        raise ValueError(f"{world} devices do not split into {num_dcn} "
                         "DCN groups")
    return init_device_mesh(mesh_device_type(), (num_dcn, world // num_dcn),
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_train_step(train_step: Callable, mesh: DeviceMesh,
                           axis_names: Tuple[str, str] = (DCN_AXIS,
                                                          ICI_AXIS)
                           ) -> Callable:
    """Hierarchical data parallelism for a plain train step: the batch
    splits over ``dcn x ici`` (row-major), the loss and gradients are
    summed over "ici" and then over "dcn" and divided by the world
    size."""
    dcn, ici = axis_names
    groups = [mesh.get_group(ici), mesh.get_group(dcn)]
    world = mesh.size()
    return wrap_step(train_step, mesh, make_grad_mean(groups, world))


def process_local_batch(mesh: DeviceMesh, local_batch: Sequence
                        ) -> Tuple[torch.Tensor, ...]:
    """This process's share of a global batch, loaded by this process
    alone (numpy arrays or tensors), on this rank's device; the steps
    take it with ``local=True``.  Every rank's share has one size."""
    dev = local_device()
    return tuple(torch.as_tensor(x).to(dev) for x in local_batch)
