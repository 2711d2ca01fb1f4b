"""The train step: loss -> gradients -> optimizer (port of
``repro.training.train_loop``).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  Microbatching slices the batch along its first axis,
runs forward and backward on each slice and sums the gradients in
``accum_dtype``, as the JAX ``lax.scan`` does.  ``abstract_train_state``
gives the state's shapes and dtypes on the ``meta`` device (nothing is
allocated) beside its logical axes, and ``state_specs`` the spec every
leaf resolves to on a mesh.

With ``mesh`` (a ("data", "model") ``DeviceMesh``: ``launch.mesh.
make_local_mesh``'s (world, 1), or one from ``make_elastic_mesh`` /
``training.elastic.plan_remesh`` or the caller) the step is data
parallel with FSDP over ``data`` and, for the attention, MLP, MoE,
Mamba and xLSTM stacks, tensor parallel over ``model``.  Every leaf is
laid out by the spec it resolves to on the mesh (``state_specs``); a
dimension that does not divide stays whole (``sharding.rules``) and is
computed whole on every rank.  Over ``data``:

* every rank is given the global batch and takes its own rows;
* a leaf whose spec shards a dimension over ``data`` (the ``embed_w``
  axis: every weight matrix, the embedding, the MoE experts and router)
  is held as this rank's shard between steps, as are its AdamW moments
  and every Adafactor statistic whose spec shards.  The parameter shards
  are all-gathered before the forward; their gradients (float32) are
  reduce-scattered, the others all-reduced, both as means over ranks;
* the loss's token count and the MoE load statistics are summed over
  ranks inside the forward (``sharding.data_parallel``), so the mean of
  the ranks' losses and gradients is the global batch's, and the MoE
  routes each rank's rows as its own dispatch group (``models.moe``);
* AdamW updates each shard with the global gradient norm; Adafactor's
  factored statistics are taken on the gradient gathered over ``data``
  (every gradient is all-reduced whole over ``data``, and the statistics
  gathered for the update): it holds a float32 gradient of each
  parameter's ``model`` block during the update, and saves only the
  parameter and statistic shards between steps.

Over ``model`` (``sharding.tensor_parallel``): the attention and
cross-attention heads (``wq``/``wk``/``wv`` by columns, ``wo`` by rows;
where a spec cuts inside a head the split projections are gathered whole
and every rank attends every head, ``models.attention``), the MLP's
``d_ff``, the MoE's experts (each model rank routes its own dispatch
group and exchanges the packed buffer by all-to-all; a batch that routes
in fewer groups than ranks is routed whole on every rank, each running
its own experts over every group, ``models.moe``), Mamba's ``d_inner``
channels (``in_proj``'s product exchanged into each rank's channels of
x and z, ``models.ssm``), the xLSTM heads (the sLSTM's gate product
exchanged into each rank's heads, ``models.xlstm``) and the vocabulary
(embedding rows, head columns, a tied head reading the embedding's
block; with the audio frontend the frames enter whole and only the head
is split) are split; every rank of a ``model`` group takes its ``data``
rank's whole batch, the blocks' partial results are all-reduced forward
and their inputs' gradients backward, and the loss is the vocab-parallel
cross entropy.  The leaves' gathers are over ``data`` only: a rank keeps
its ``model`` block.  The global gradient norm sums each leaf's squares
over the axes it is split over, each leaf once; a leaf split over
neither is computed identically on every model rank and stays
bit-identical there.  AdamW updates the blocks elementwise; Adafactor
updates each rank's blocks too, its factored statistics' means over a
split dimension summed over ``model`` (``optimizer.apply_updates``'s
``split``), so no rank holds a whole split gradient.  A Mamba
``d_inner`` or an xLSTM head count that does not divide over ``model``
while the block's projections do has the split projections (or
``in_proj``'s product) gathered whole, every rank running every channel
or head.

The residual stream between blocks follows the rules active where the
step is called (``sharding.use_mesh(mesh, rules)``; ``DEFAULT_RULES``
otherwise): where ``seq_sp`` resolves to ``model`` for the sequence
length, each rank of a ``model`` group holds its block of the positions
between blocks (Megatron's sequence parallelism: the embedding's sum and
every block's row-split output reduce-scattered along the sequence, each
block's normed input all-gathered, the norms' weights' gradients summed),
so remat saves a ``(B, S / model, D)`` input a block; else the stream is
whole on every rank (``sharding.tensor_parallel``).

With ``mesh=None`` or a mesh of one rank the step is the single-device
one bit for bit; at ``model`` 1 it is the data-parallel step above.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.models.model import LM
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding import current_rules, use_mesh
from repro_torch.sharding.partition import (gather_shard, local_shard,
                                            tree_specs)
from repro_torch.sharding.rules import (is_axes_leaf, mesh_axis_sizes,
                                        spec_axes)
from repro_torch.sharding.tensor_parallel import split_over_model
from repro_torch.training.checkpoint import flatten
from repro_torch.training.optimizer import (OptConfig, OptState, _batches,
                                            apply_updates, init_opt_state,
                                            opt_state_axes)


class TrainState(NamedTuple):
    """The model, whose parameters the step updates in place, and the
    optimizer state.  ``params`` is the model's parameters by name.  The
    axes tree of :func:`abstract_train_state` has the same fields with
    ``model`` the parameters' logical axes by name."""
    model: LM
    opt: OptState

    @property
    def params(self):
        return dict(self.model.named_parameters())


def init_train_state(cfg, opt_cfg: OptConfig, *, device=None,
                     seed: int = 0) -> TrainState:
    """A freshly initialised ``LM(cfg)`` (weights from ``seed``) with its
    parameters set to require gradients, and zero optimizer state."""
    lm = LM(cfg, device=device, seed=seed)
    lm.requires_grad_(True)
    return TrainState(lm, init_opt_state(dict(lm.named_parameters()),
                                         opt_cfg, len(cfg.block_pattern)))


def abstract_train_state(cfg, opt_cfg: OptConfig):
    """(TrainState on the ``meta`` device, its logical-axes TrainState):
    shapes and dtypes only, no allocation."""
    state = init_train_state(cfg, opt_cfg, device="meta")
    p_axes = state.model.param_axes()
    o_axes = opt_state_axes(p_axes, opt_cfg, len(cfg.block_pattern))
    return state, TrainState(model=p_axes, opt=o_axes)


def state_specs(cfg, opt_cfg: OptConfig, mesh, rules=None) -> Dict:
    """{checkpoint path ("model/<name>", "opt/m/<key>", ...): the
    PartitionSpec of that leaf of the train state on ``mesh``}."""
    shapes, axes = abstract_train_state(cfg, opt_cfg)
    return tree_specs(dict(flatten(shapes)),
                      dict(flatten(axes, is_leaf=is_axes_leaf)), mesh, rules)


def _mean_over(group, world: int, t: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of float32 ``t`` (in place)."""
    dist.all_reduce(t, group=group)
    return t.div_(world)


def _sq_sum(tensors, like: torch.Tensor) -> torch.Tensor:
    """The sum of squares of every element of ``tensors``, in float32 (a
    narrower gradient is widened a bounded run at a time)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return torch.stack([x for run in _batches(tensors)
                        for x in torch._foreach_norm(
                            [t.float() for t in run])]).square().sum()


def _reduce_scatter_mean(g: torch.Tensor, spec, group, world: int):
    """This rank's block (by ``spec``, sharded over ``data`` on one
    dimension) of the mean over ranks of the full gradient ``g``."""
    from repro_torch.sharding.compat import reduce_scatter_single
    d = next(i for i, e in enumerate(spec) if "data" in spec_axes(e))
    front = g.float().movedim(d, 0).contiguous()
    out = torch.empty((front.shape[0] // world,) + front.shape[1:],
                      dtype=torch.float32, device=g.device)
    reduce_scatter_single(out, front, group=group)
    return out.div_(world).movedim(0, d)


def make_train_step(cfg, opt_cfg: OptConfig, microbatches: int = 1,
                    remat: bool = True, accum_dtype: str = "float32",
                    mesh=None):
    """``accum_dtype``: the gradient-accumulation buffers' dtype when
    ``microbatches`` > 1.  The batch's leading axis (per rank, on a mesh)
    must divide by ``microbatches``.  ``mesh``: see the module docstring."""
    acc_dt = getattr(torch, accum_dtype)
    period = len(cfg.block_pattern)

    def grads_of(lm, batch):
        for p in lm.parameters():
            p.grad = None
        loss = lm.loss(batch, remat=remat)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in lm.named_parameters()}

    def loss_and_grads(lm, batch):
        lm.requires_grad_(True)
        if microbatches == 1:
            loss, grads = grads_of(lm, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            acc = {name: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for name, p in lm.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=lm.device)
            for i in range(microbatches):
                mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                mb_loss, g = grads_of(lm, mb)
                for name, a in acc.items():
                    acc[name] = (a + g[name].to(acc_dt)).to(acc_dt)
                loss = loss + mb_loss
            loss = loss / microbatches
            grads = {name: a.float() / microbatches
                     for name, a in acc.items()}
        for p in lm.parameters():
            p.grad = None
        return loss, grads

    def train_step(state: TrainState, batch):
        lm = state.model
        loss, grads = loss_and_grads(lm, batch)
        _, opt, metrics = apply_updates(dict(lm.named_parameters()), grads,
                                        state.opt, opt_cfg, period)
        metrics["loss"] = loss
        return TrainState(lm, opt), metrics

    if mesh is None:
        return train_step
    sizes = mesh_axis_sizes(mesh)
    world, n_model = sizes.get("data", 1), sizes.get("model", 1)
    specs = state_specs(cfg, opt_cfg, mesh) if world * n_model > 1 else None
    if world * n_model == 1:
        def one_rank_step(state, batch):
            with use_mesh(mesh, current_rules()):
                return train_step(state, batch)
        return one_rank_step

    group = mesh.get_group("data") if world > 1 else None
    mgroup = mesh.get_group("model") if n_model > 1 else None
    rank = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["data"]
    full_shape = {p: s.shape for p, s in flatten(
        abstract_train_state(cfg, opt_cfg)[0])}

    def pspec(name):
        return specs[f"model/{name}"]

    def over(name) -> tuple:
        """The mesh axes parameter ``name`` is split over, sorted."""
        return tuple(sorted({a for e in pspec(name) for a in spec_axes(e)}))

    def to_shards(tree: dict, prefix: str) -> None:
        """Cut the full leaves of ``tree`` (in place) to their shards."""
        for k, t in tree.items():
            path = f"{prefix}/{k}"
            if specs[path] and t.shape == full_shape[path]:
                tree[k] = local_shard(t, specs[path], mesh)

    def global_sq(g: dict, like, axes=("data", "model")) -> torch.Tensor:
        """The squares of every gradient summed over the mesh: each
        leaf's block summed over the ``axes`` it is split over, each leaf
        counted once."""
        keys = {}
        for k in g:
            keys.setdefault(tuple(a for a in over(k) if a in axes),
                            []).append(k)
        sq = None
        for ax in sorted(keys, key=lambda a: (-len(a), a)):
            part = _sq_sum([g[k] for k in keys[ax]], like)
            if "data" in ax:
                _mean_over(group, 1, part)
            if "model" in ax:
                tp.all_reduce(part, mgroup)
            sq = part if sq is None else sq + part
        return sq

    def model_split(k):
        """(dim, group, full length) of the dimension of parameter ``k``
        split over ``model``, counted from the end, or None."""
        full = full_shape[f"model/{k}"]
        for d in range(len(full)):
            if split_over_model(pspec(k), d):
                return d - len(full), mgroup, full[d]
        return None

    def dp_step(state: TrainState, batch):
        lm, opt = state.model, state.opt
        params = dict(lm.named_parameters())
        b = next(iter(batch.values())).shape[0]
        if b % world:
            raise ValueError(f"batch {b} does not divide over {world} ranks")
        n = b // world
        local = {k: x[rank * n:(rank + 1) * n] for k, x in batch.items()}
        # a full state (fresh or restored on one device) is cut on entry
        shards = {k: p.data for k, p in params.items()}
        to_shards(shards, "model")
        for tree, name in ((opt.m, "m"), (opt.v, "v")):
            to_shards(tree, f"opt/{name}")
        split = [k for k in params if pspec(k)]
        fsdp = [k for k in split if "data" in over(k)]
        tp_split = [k for k in split if "model" in over(k)]
        for k in split:
            # gathered over data; a model block stays this rank's
            params[k].data = gather_shard(shards[k], pspec(k), mesh,
                                          axes=("data",))
        with use_mesh(mesh, current_rules()):
            loss, grads = loss_and_grads(lm, local)
        if world > 1:
            loss = _mean_over(group, world, loss.float().clone())
        if opt_cfg.kind == "adamw":
            g = {k: (_reduce_scatter_mean(x, pspec(k), group, world)
                     if k in fsdp else _mean_over(group, world,
                                                  x.float().clone()))
                 for k, x in grads.items()} if world > 1 else grads
            for k in fsdp:
                params[k].data = shards[k]
            _, new_opt, metrics = apply_updates(
                params, g, opt, opt_cfg, period,
                gnorm=global_sq(g, loss).sqrt())
        else:
            g = {k: _mean_over(group, world, x.float().clone())
                 if world > 1 else x for k, x in grads.items()}
            # each rank updates its model blocks: the factored statistics'
            # means over a split dimension are summed over model
            cut = {k: model_split(k) for k in tp_split}
            cut = {k: c for k, c in cut.items() if c is not None}
            state_over_data = OptState(opt.step, *(
                {k: gather_shard(t, specs[f"opt/{name}/{k}"], mesh,
                                 axes=("data",))
                 for k, t in tree.items()}
                for tree, name in ((opt.m, "m"), (opt.v, "v"))))
            _, new_opt, metrics = apply_updates(
                params, g, state_over_data, opt_cfg, period,
                gnorm=global_sq(g, loss, axes=("model",)).sqrt()
                if n_model > 1 else None, split=cut)
            for tree, name in ((new_opt.m, "m"), (new_opt.v, "v")):
                for k, t in tree.items():
                    tree[k] = local_shard(t, specs[f"opt/{name}/{k}"], mesh,
                                          axes=("data",))
            for k in split:
                params[k].data = local_shard(params[k].data, pspec(k), mesh,
                                             axes=("data",))
        metrics["loss"] = loss
        return TrainState(lm, new_opt), metrics

    return dp_step
