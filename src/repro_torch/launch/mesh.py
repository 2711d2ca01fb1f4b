"""Meshes (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module starts no process
group.

* :func:`make_production_mesh` — the dry run's meshes, shape only
  (:class:`~repro_torch.sharding.rules.MeshShape`): (16, 16) over
  ("data", "model"), or (2, 16, 16) over ("pod", "data", "model").  No
  process stands behind them.
* :func:`make_local_mesh` — the processes that exist, as a (world, 1)
  ("data", "model") ``DeviceMesh``: NCCL on the card, gloo on the CPU.
  Under ``torchrun`` the group comes from its environment; with no
  launcher a group of one is started in process (a ``HashStore``: no
  port, no file).
* :func:`make_elastic_mesh` — the mesh after node loss: the model axis
  kept whole, the data axis whatever is left.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.models.model import resolve_device
from repro_torch.sharding.rules import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def init_group(device=None) -> torch.device:
    """Start the default process group unless one is up (``torchrun``'s
    environment, else a group of one) and return this rank's device: the
    card of its local rank, or the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return device


def _device_mesh(device: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=names)


def make_local_mesh(device=None):
    """Every process of the group as a (world, 1) ("data", "model")
    ``DeviceMesh`` (on the card unless ``device`` says otherwise)."""
    device = init_group(device)
    return _device_mesh(device, (dist.get_world_size(), 1),
                        ("data", "model"))


def make_elastic_mesh(device_count: int, model_parallel: int = 16,
                      device=None):
    """Rebuild a mesh after losing nodes: keep the model axis intact (TP
    shards of the weights must survive) and shrink the data axis to what
    is left, 512 -> 256 -> 128 ...  The survivors are a relaunched
    process group of exactly ``device_count`` ranks."""
    if device_count % model_parallel:
        raise ValueError(
            f"{device_count} devices not divisible by model={model_parallel}")
    device = init_group(device)
    world = dist.get_world_size()
    if device_count != world:
        raise ValueError(
            f"{device_count} devices asked for, the process group has "
            f"{world}: relaunch with the surviving ranks")
    return _device_mesh(device, (device_count // model_parallel,
                                 model_parallel), ("data", "model"))
