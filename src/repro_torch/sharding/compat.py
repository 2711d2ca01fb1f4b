"""Cross-version torch shims for the sharding substrate (the counterpart of
``repro.sharding.compat``, which papers over jax's ``shard_map`` moves).

* ``torch.distributed.all_gather_single`` and ``reduce_scatter_single``
  are the current names of the single-tensor collectives;
  ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` are the older
  ones (deprecated where the new ones exist, the only ones on older
  releases).
* DTensor's placements live in ``torch.distributed.tensor`` on current
  releases and in ``torch.distributed._tensor`` on older ones.
"""

from __future__ import annotations

import importlib

import torch
import torch.distributed as dist


def all_gather_single(inp, group=None):
    """(world, *inp.shape): every rank's ``inp``, rank-major."""
    n = dist.get_world_size(group)
    out = torch.empty(n * inp.numel(), dtype=inp.dtype, device=inp.device)
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp.contiguous().view(-1), group=group)
    return out.view((n,) + tuple(inp.shape))


def reduce_scatter_single(out, inp, group=None) -> None:
    """``out`` <- this rank's chunk of the sum over ranks of ``inp``
    (world * out.numel() elements, rank-major)."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out.view(-1), inp.contiguous().view(-1), op=dist.ReduceOp.SUM,
       group=group)


def dtensor():
    """The DTensor module (``Shard``, ``Replicate``, ``DTensor``,
    ``distribute_tensor``) under whichever path this torch has."""
    try:
        return importlib.import_module("torch.distributed.tensor")
    except ImportError:
        return importlib.import_module("torch.distributed._tensor")
