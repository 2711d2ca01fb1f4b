"""Tensor parallelism over the mesh's ``model`` axis (Megatron's column
and row split, the port's counterpart of the GSPMD split the JAX model's
``constrain`` hints ask for).

The train step (``training.train_loop.make_train_step(mesh=)``) keeps
each weight as the block its spec gives it (``state_specs``): a block's
module reads whether it is split from its weight's width, and finds the
axis's process group on the active mesh (:func:`group_for`).

* Attention: ``wq``/``wk``/``wv`` column-split (this rank's heads),
  ``wo`` row-split; MLP: ``w_gate``/``w_up`` column-split, ``w_down``
  row-split.  The block's normed input enters through
  :func:`copy_to_model` (identity forward, all-reduce backward) and the
  row-split product leaves through :func:`reduce_from_model` (all-reduce
  forward, identity backward); ``q_norm``/``k_norm`` are whole on every
  rank and read through :func:`copy_to_model` too, so their gradients
  are the sums over every rank's heads.
* Embedding and head: each rank holds a block of vocabulary rows; the
  lookup is masked to them and summed (:func:`vocab_parallel_embedding`),
  and the loss's log-sum-exp and target logit are all-reduced
  (``models.model``).

Both Functions are the identity on a group of one (``group=None``).
Every collective of this module goes through :func:`all_reduce`, which
counts its calls and the bytes handed to it in ``COLLECTIVES``.

:func:`check_layout` refuses, before any process group is touched, the
stacks and layouts the step does not execute over ``model``: MoE, Mamba,
xLSTM, cross-attention and the audio frontend, and a spec that cuts
inside a head or puts a rank's query heads and their KV heads apart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as Fn

from repro_torch.sharding import current_mesh
from repro_torch.sharding.rules import mesh_axis_sizes, spec_axes

#: calls and bytes this rank has handed to all-reduces over ``model``
COLLECTIVES = {"calls": 0, "bytes": 0}


def reset_collectives() -> None:
    COLLECTIVES.update(calls=0, bytes=0)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """``t`` reduced over ``group`` in place (counted)."""
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def model_parallel():
    """(process group, size, this rank's index) of the active mesh's
    ``model`` axis when it is a ``DeviceMesh`` axis of more than one
    rank, else (None, 1, 0)."""
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "mesh_dim_names", None) is None:
        return None, 1, 0
    n = mesh_axis_sizes(mesh).get("model", 1)
    if n == 1:
        return None, 1, 0
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return mesh.get_group("model"), n, coord["model"]


def group_for(split: bool):
    """The ``model`` group when a module's weight is split over it (its
    width is a block of the full one), else None."""
    if not split:
        return None
    group, _, _ = model_parallel()
    if group is None:
        raise RuntimeError("a weight is split over 'model' but no mesh "
                           "with a model axis is active (sharding.use_mesh)")
    return group


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: the incoming gradient may be shared with another branch
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    """x as is; its gradient summed over ``group`` (the input of a
    column-split product, or a whole weight read by split work)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """x summed over ``group`` (the partial output of a row-split
    product); its gradient as is."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def vocab_parallel_embedding(tokens, shard, group, rank: int):
    """Token embeddings from this rank's block of vocabulary rows
    ``shard`` (rows ``rank * len(shard)`` on): the rows it owns looked
    up, the others zero, summed over ``group``.  Exact: each position
    sums one row with zeros."""
    n = shard.shape[0]
    local = tokens - rank * n
    own = (local >= 0) & (local < n)
    emb = Fn.embedding(local.clamp(0, n - 1), shard)
    return reduce_from_model(emb.masked_fill(~own[..., None], 0), group)


# ------------------------------------------------------------ the layout
#: why each block kind is not executed over ``model`` (the next slices)
REFUSED = {"attn_moe": "MoE (the expert all-to-all)",
           "mamba": "Mamba (ssm_inner)",
           "mamba_moe": "Mamba (ssm_inner) and MoE (the expert all-to-all)",
           "mlstm": "xLSTM", "slstm": "xLSTM", "xattn": "cross-attention"}


def split_over_model(spec, dim: int) -> bool:
    return len(spec) > dim and "model" in spec_axes(spec[dim])


def check_layout(cfg, specs: dict, mesh) -> None:
    """Raise ValueError unless the train step executes ``cfg`` over
    ``mesh``'s ``model`` axis with the parameter ``specs`` ({"model/<name>":
    PartitionSpec}, ``state_specs``)."""
    sizes = mesh_axis_sizes(mesh)
    n = sizes.get("model", 1)
    where = (f"tensor-parallel execution over 'model' ({n}) covers "
             "attention + MLP stacks only")
    if cfg.audio_frontend:
        raise ValueError(f"make_train_step: {cfg.name} reads frames through "
                         f"the audio frontend; {where}")
    for kind in cfg.block_pattern:
        if kind in REFUSED:
            raise ValueError(f"make_train_step: {cfg.name} has {kind} "
                             f"blocks ({REFUSED[kind]}); {where}")
    # in these stacks the rules split over 'model' only the heads' widths
    # (qkv), d_ff (mlp) and the vocabulary; the MLP's and the vocabulary's
    # leaves split alike (one dimension each), the query and KV widths
    # need not
    for i in range(cfg.num_layers):
        pre = f"model/blocks.{i}.attn."
        q = split_over_model(specs[pre + "wq"], 1)
        for leaf, heads in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads)):
            spec = specs[pre + leaf]
            split = split_over_model(spec, 1)
            if split and heads % n:
                raise ValueError(
                    f"make_train_step: {cfg.name} leaf {pre}{leaf} ({heads} "
                    f"heads of width {cfg.head_dim}) laid out {spec} on mesh "
                    f"{sizes} cuts inside a head; tensor-parallel execution "
                    "over 'model' needs whole heads on each rank")
            if split != q:
                raise ValueError(
                    f"make_train_step: {cfg.name} leaf {pre}{leaf} laid out "
                    f"{spec} on mesh {sizes} splits the query heads and "
                    "their KV heads apart (one over 'model', the other "
                    "whole); tensor-parallel execution over 'model' needs "
                    "each rank's query heads beside their KV heads")
