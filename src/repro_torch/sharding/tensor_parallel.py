"""Tensor parallelism over the mesh's ``model`` axis (Megatron's column
and row split, and the MoE expert split with its all-to-all: the port's
counterpart of the GSPMD split the JAX model's ``constrain`` hints and
its MoE ``shard_map`` ask for).

The train step (``training.train_loop.make_train_step(mesh=)``) keeps
each weight as the block its spec gives it (``state_specs``): a block's
module reads whether it is split from its weight's width, and finds the
axis's process group on the active mesh (:func:`group_for`).

* Attention, whole heads on each rank: ``wq``/``wk``/``wv``
  column-split (this rank's heads), ``wo`` row-split; MLP:
  ``w_gate``/``w_up`` column-split, ``w_down`` row-split.  The block's
  normed input enters through :func:`copy_to_model` (identity forward,
  all-reduce backward) and the row-split product leaves through
  :func:`reduce_from_model` (all-reduce forward, identity backward);
  ``q_norm``/``k_norm`` are whole on every rank and read through
  :func:`copy_to_model` too, so their gradients are the sums over every
  rank's heads.  Cross-attention splits the same way, its K/V projected
  from the image embeddings (replicated inputs: no collective) by this
  rank's ``wk``/``wv`` columns.
* Attention, heads cut across ranks (a spec that cuts inside a head, or
  ``wq`` split while ``wk`` stays whole): the split projections are
  gathered whole (:func:`gather_sum_grad`), every rank attends all the
  heads, takes its own columns of the output into its ``wo`` rows and
  the products are summed as above (``models.attention``).
* MoE (``models.moe``): each rank routes its own dispatch group through
  the router gathered whole and exchanges the packed buffer with its
  ``model`` group (:func:`all_to_all_model`) so that it runs its own
  experts; the combined rows are gathered back (:func:`gather_own_grad`).
  A batch that routes in fewer groups than ranks is routed whole on
  every rank, each running its own experts over every group's slots,
  and the experts' outputs are gathered (:func:`gather_own_grad`).
* Mamba (``models.ssm``), this rank's block of ``d_inner``'s channels:
  ``in_proj``'s block of columns is a block of ``[x | z]`` (at model 2
  one rank holds all of x, the other all of z), so its product is
  exchanged by all-to-all (:func:`own_channels`) into this rank's
  channels of both; the depthwise conv, the scan and the states are per
  channel; the row-split ``x_proj`` product (B, C, dt), read whole by
  every channel, is summed forward and backward
  (:func:`reduce_sum_grad`); ``out_proj`` is row-split.  Where
  ``d_inner`` does not divide while ``in_proj``'s 2 x ``d_inner`` does,
  ``in_proj``'s product is gathered whole (:func:`gather_own_grad`) and
  every rank runs every channel through the whole ``out_proj``.
* xLSTM (``models.xlstm``), whole heads on each rank: the mLSTM as
  attention (``wq``/``wk``/``wv``/``wi``/``wf`` column-split, ``wo_out``
  row-split); the sLSTM's ``w_gates`` block holds some of the four gates
  of every head, and its product is exchanged into all four gates of
  this rank's heads (:func:`own_channels`), whose recurrence then runs
  with no collective inside the token loop; each block's up/down as the
  MLP.  Where the heads do not divide while the projections do, the
  split projections (``wq``/``wk``/``wv``, ``w_gates``, ``b_gates``) are
  gathered whole (:func:`gather_sum_grad`), the whole ones (``wi``,
  ``wf``, ``r_gates``) read through :func:`copy_to_model`, and every
  rank runs every head and takes its own columns into its ``wo_out``
  rows, as cut attention heads do.
* Embedding and head: each rank holds a block of vocabulary rows; the
  lookup is masked to them and summed (:func:`vocab_parallel_embedding`),
  and the loss's log-sum-exp and target logit are all-reduced
  (``models.model``).  With the audio frontend the frames enter whole on
  every rank and only the head is split.

The residual stream between blocks (Megatron's sequence parallelism, the
JAX stack's ``constrain(x, "batch", "seq_sp", "embed")``): where the
active rules resolve ``seq_sp`` to ``model`` for the stream's length
(:func:`seq_parallel`), each rank holds its contiguous block of the
positions, in rank order.  The embedding's sum is reduce-scattered along
the sequence (the audio frontend's frames are cut to the rank's block);
every block norms its own positions (the norm weight read through
:func:`copy_to_model`, its gradient summed), gathers the normed input
along the sequence where :func:`copy_to_model` stood
(:func:`from_stream`), runs its work on every position, reduce-scatters
its row-split output where :func:`reduce_from_model` stood
(:func:`to_stream`, :func:`scatter_sum`) and adds the residual on its
block; a block whose work is whole gathers its input with
:func:`gather_own_grad` and keeps its own positions of its output
(:func:`own_block`).  The final norm runs on the block and the head's
input is gathered.  Otherwise (the rules map ``seq_sp`` to nothing, or
the length does not divide) the stream is whole on every rank.

Every Function is the identity on a group of one (``group=None``).  Every
collective of this module goes through :func:`all_reduce`,
:func:`all_gather`, :func:`reduce_scatter` or :func:`all_to_all`, which
count their calls and the bytes handed to them in ``COLLECTIVES`` by
kind (the whole buffer: an all-gather's output, a reduce-scatter's
input).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as Fn

from repro_torch.sharding import current_mesh, current_rules
from repro_torch.sharding.compat import (all_gather_single,
                                         reduce_scatter_single)
from repro_torch.sharding.rules import mesh_axis_sizes, spec_axes, spec_for

#: the collectives over ``model`` by kind
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
#: calls and bytes this rank has handed to each kind of collective over
#: ``model``
COLLECTIVES = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v.update(calls=0, bytes=0)


def snapshot() -> dict:
    """A copy of ``COLLECTIVES``."""
    return {k: dict(v) for k, v in COLLECTIVES.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind]["calls"] += 1
    COLLECTIVES[kind]["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """``t`` reduced over ``group`` in place (counted)."""
    _count("all-reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order
    (counted: the gathered buffer)."""
    out = all_gather_single(t, group)
    _count("all-gather", out)
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` of ``t``
    (counted: the whole input)."""
    n = dist.get_world_size(group)
    _count("reduce-scatter", t)
    front = t.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + front.shape[1:],
                      dtype=t.dtype, device=t.device)
    reduce_scatter_single(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def all_to_all(t: torch.Tensor, group, send=None,
               recv=None) -> torch.Tensor:
    """``t``'s leading dimension cut into one block per rank of
    ``group``; block j goes to rank j, and block j of the result is
    the one rank j sent here (counted: the input).  The blocks are equal
    unless ``send`` gives each one's rows, and then ``recv`` gives the
    rows each rank sends here."""
    t = t.contiguous()
    if send is None:
        out = torch.empty_like(t)
    else:
        out = t.new_empty((sum(recv),) + t.shape[1:])
    _count("all-to-all", t)
    dist.all_to_all_single(out, t, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


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


def seq_parallel(batch: int, seq: int):
    """The ``model`` group when the residual stream (batch, seq, d_model)
    between blocks is this rank's block of positions: the active rules
    resolve ``("batch", "seq_sp", "embed")``'s sequence dimension to
    ``model`` on the active mesh, over more than one rank; else None (the
    stream whole on every rank)."""
    group, _, _ = model_parallel()
    if group is None:
        return None
    spec = spec_for((batch, seq, 1), ("batch", "seq_sp", "embed"),
                    current_mesh(), current_rules())
    return group if split_over_model(spec, 1) else None


def from_stream(h, group, sp):
    """The normed stream ``h`` as a block's work reads it.  On a whole
    stream (``sp`` None), :func:`copy_to_model` over ``group``, the
    ``model`` group when the work is split over it (each rank's gradient
    is its share).  On a stream split by positions, every rank's block
    gathered along the sequence: its gradient reduce-scattered where the
    work is split, this rank's block of it where the work is whole
    (every rank's gradient is then the same)."""
    if sp is None:
        return copy_to_model(h, group)
    if group is None:
        return gather_own_grad(h, sp, 1)
    return gather_sum_grad(h, sp, 1)


def to_stream(y, group, sp):
    """A block's output ``y`` (B, S, D) as the residual adds it: summed
    over ``group`` where the work is split (:func:`reduce_from_model`),
    and on a stream split by positions (``sp``) this rank's block of the
    sum (:func:`scatter_sum`) or, from whole work, of y
    (:func:`own_block`)."""
    if sp is None:
        return reduce_from_model(y, group)
    if group is None:
        return own_block(y, sp, 1)
    return scatter_sum(y, sp, 1)


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


class _GatherSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherOwnGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _ReduceSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return all_to_all(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        # the reverse exchange: block j of g goes back to rank j
        return all_to_all(g, ctx.group, ctx.recv, ctx.send), None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _OwnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


def gather_sum_grad(x, group, dim: int):
    """Every rank's block ``x`` of a tensor split along ``dim`` over
    ``group``, gathered whole; its gradient is reduce-scattered, because
    the readers are split work whose gradients are partial on each rank
    (a split weight read whole by every rank's share of a block)."""
    return x if group is None else _GatherSumGrad.apply(x, group, dim)


def gather_own_grad(x, group, dim: int):
    """Every rank's block ``x`` gathered whole along ``dim``; its gradient
    is this rank's block of the incoming one, because the readers are
    replicated and each rank's gradient is already the whole (the MoE's
    combined rows)."""
    return x if group is None else _GatherOwnGrad.apply(x, group, dim)


def scatter_sum(x, group, dim: int):
    """This rank's block along ``dim`` of x summed over ``group``
    (reduce-scatter); its gradient all-gathered, because every rank's
    block is read by its own positions alone (a row-split product's
    partial output entering a residual stream split by positions)."""
    return x if group is None else _ScatterSum.apply(x, group, dim)


def own_block(x, group, dim: int):
    """This rank's block along ``dim`` of x, which is whole and the same
    on every rank of ``group``; its gradient all-gathered, so that the
    replicated work that made x gets the whole gradient on every rank
    (a whole block's output entering a stream split by positions)."""
    return x if group is None else _OwnBlock.apply(x, group, dim)


def reduce_sum_grad(x, group):
    """x summed over ``group``, and its gradient summed too: the partial
    output of a row-split product that split work reads whole (each
    rank's gradient of it is its own readers' share; Mamba's ``x_proj``
    product)."""
    return x if group is None else _ReduceSumGrad.apply(x, group)


def all_to_all_model(x, group, send=None, recv=None):
    """:func:`all_to_all` over ``group`` of x's leading blocks (equal, or
    ``send`` rows to each rank and ``recv`` from each), its gradient the
    reverse exchange."""
    return x if group is None else _AllToAll.apply(x, group, send, recv)


def own_channels(x, groups: int, group):
    """This rank's channels of every group, from its block of columns.

    ``x`` (..., W) is this rank's block of the columns of a product whose
    full width is ``groups`` equal groups of channels side by side (Mamba's
    ``[x | z]``, the sLSTM's four gates), the block rank r of ``group``
    holds being columns [r W, (r + 1) W).  Each group's channels are cut
    into one equal piece per rank; the pieces are exchanged by one
    all-to-all (per-rank sizes where a block covers some ranks' pieces
    only) so that rank r gets piece r of every group.  Returns
    (..., groups, W / groups).  Its gradient is the reverse exchange."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    piece = x.shape[-1] // groups
    # the full width as groups x n pieces, group-major: this rank holds
    # pieces r * groups .. r * groups + groups - 1, piece p goes to rank
    # p % n, and rank r is sent piece g * n + r of every group g
    dest = [(r * groups + k) % n for k in range(groups)]
    order = sorted(range(groups), key=dest.__getitem__)
    send = [dest.count(j) for j in range(n)]
    src = [(g * n + r) // groups for g in range(groups)]
    recv = [src.count(j) for j in range(n)]
    pieces = x.reshape(-1, groups, piece).transpose(0, 1)[order]
    if send == recv == [groups // n] * n:
        send = recv = None
    got = all_to_all_model(pieces, group, send, recv)
    return got.transpose(0, 1).reshape(*x.shape[:-1], groups, piece)


def vocab_parallel_embedding(tokens, shard, group, rank: int, sp=None):
    """Token embeddings from this rank's block of vocabulary rows
    ``shard`` (rows ``rank * len(shard)`` on): the rows it owns looked
    up, the others zero, summed over ``group`` (with ``sp``, the stream
    split by positions, this rank's block of the sum along the sequence).
    Exact: each position sums one row with zeros."""
    n = shard.shape[0]
    local = tokens - rank * n
    own = (local >= 0) & (local < n)
    emb = Fn.embedding(local.clamp(0, n - 1), shard)
    return to_stream(emb.masked_fill(~own[..., None], 0), group, sp)


# ------------------------------------------------------------ the layout
def split_over_model(spec, dim: int) -> bool:
    return len(spec) > dim and "model" in spec_axes(spec[dim])
