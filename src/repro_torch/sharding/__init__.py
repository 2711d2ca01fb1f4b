"""Sharding context and the activation-constraint hook (port of
``repro.sharding``).

The launcher activates a mesh with :func:`use_mesh`.  ``constrain(x,
*axes)`` lays a DTensor out by the logical axes under the active mesh;
off a mesh, on a mesh of one device, and for a plain (non-DTensor)
tensor it is the identity.  The port's model does not call it: the
train step (``training.train_loop.make_train_step(mesh=)``) executes
FSDP over ``data`` and, for the dense attention stacks, tensor
parallelism over ``model`` with plain tensors, each rank holding its
block of every weight, and the split blocks sum their partial results
themselves (``sharding.tensor_parallel``, Megatron's column and row
split in place of the JAX model's hints).

Inside a ``use_mesh`` block the model reads three things from the
active mesh: the MoE dispatch group count (``models.moe``); for a
``DeviceMesh`` whose ``data`` axis spans several processes,
:func:`data_parallel`'s group, over which the loss's token count and the
MoE load statistics are summed; and for one whose ``model`` axis does,
``tensor_parallel.model_parallel``'s group and this rank's index on it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, Optional, Tuple

from repro_torch.sharding.rules import (DEFAULT_RULES, mesh_axis_sizes,
                                        placements_for, spec_for)

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules():
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Mapping[str, Tuple[str, ...]]] = None):
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", DEFAULT_RULES)
    _state.mesh = mesh
    _state.rules = rules if rules is not None else DEFAULT_RULES
    try:
        yield
    finally:
        _state.mesh = prev_mesh
        _state.rules = prev_rules


def mesh_size(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


def data_parallel():
    """(process group, size) of the active mesh's ``data`` axis when it is
    a ``DeviceMesh`` over more than one process, else (None, 1)."""
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "mesh_dim_names", None) is None:
        return None, 1
    n = mesh_axis_sizes(mesh).get("data", 1)
    return (mesh.get_group("data"), n) if n > 1 else (None, 1)


def constrain(x, *axes: Optional[str]):
    """Lay DTensor ``x`` out by the logical ``axes`` under the active mesh
    (``DTensor.redistribute``); the identity otherwise."""
    mesh = current_mesh()
    if mesh is None or mesh_size(mesh) == 1:
        return x
    from repro_torch.sharding.compat import dtensor
    if not isinstance(x, dtensor().DTensor):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"constrain: {len(axes)} axes for rank-{x.ndim} tensor")
    spec = spec_for(x.shape, axes, mesh, current_rules())
    return x.redistribute(x.device_mesh, placements_for(spec, mesh))


__all__ = [
    "use_mesh",
    "constrain",
    "current_mesh",
    "current_rules",
    "data_parallel",
    "mesh_size",
    "spec_for",
    "DEFAULT_RULES",
]
