"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro.models.moe``).

Tokens are routed in G dispatch groups (``_num_groups``, JAX's): one
group off a mesh; under an active mesh (``sharding.use_mesh``) the mesh's
size, halved until it divides the global batch's token count, the groups
holding consecutive batch rows.  Under data parallelism each rank holds
its own batch shard and routes its G / world groups: on a (world, 1)
mesh exactly one, its own rows, as each device of the JAX mesh does.
Over a ``model`` axis (expert parallelism, JAX's ``shard_map`` groups
and its ``constrain(xs, "batch", "experts", ...)``) rank (d, m) routes
group d * model + m through the router gathered whole; the packed
(E, C, D) buffer goes by one all-to-all over the model group to the
ranks that hold its experts, each rank runs its E / model experts over
every rank's slots, the outputs come back by the reverse all-to-all and
are combined per group, and the combined rows are all-gathered into the
replicated (T, D) (with the residual stream split by positions,
``sharding.tensor_parallel.seq_parallel``, the block's normed input is
gathered along the sequence first and the combined rows, zero elsewhere,
are reduce-scattered back to the rank's positions: the dispatch groups,
their capacity and their drops are JAX's whatever positions a rank
holds).  Where the experts do not divide ``model`` they stay
whole: each rank runs them all on its own group, with no all-to-all.  A
batch that routes in fewer groups than the model group has ranks (JAX
then leaves ``shard_map`` and routes every group, its expert products
still split over ``model``) is routed whole on every model rank: each
runs its own E / model experts over every group's slots and their
outputs are all-gathered along the experts, with no all-to-all; with the
experts whole every rank runs the block as one device does.

Per forward: a float32 router, softmax, top-k and gate renormalisation;
in each group the (token, choice) pairs stable-sorted by expert id and
packed into an (E, C, D) buffer of capacity ``C = max(1, ceil(Tg * K /
E * cf))`` over the group's Tg tokens (overflow dropped); one batched
product per expert weight; the gated outputs combined in float32; the
Switch load-balance auxiliary loss over the whole batch (under data
parallelism the top-1 counts are summed over ranks, so the mean of the
ranks' losses is the global batch's; over ``model`` the probabilities'
sums and the counts are summed over the model group too, so every model
rank has the same loss).

Two consequences of the reference's design the port keeps: capacity is
shared by every token of a group, so in a lane batch a lane's tokens
depend on its neighbours' routing (there is no lanes == serial contract
for MoE stacks); and every expert's capacity slots are computed, so a
decode step reads every expert's weights.  The products are plain
``torch.bmm`` (the JAX package's are einsums outside any Pallas
kernel).  Nothing here reads the device from the host.
"""

from __future__ import annotations

import math

import torch
from torch import nn

import torch.distributed as dist
import torch.nn.functional as Fn

from repro_torch.models.layers import (ACTIVATIONS, dtype_of, init_dense,
                                       init_expert_stack, ones, rmsnorm)
from repro_torch.sharding import current_mesh, data_parallel, mesh_size
from repro_torch.sharding.tensor_parallel import (all_to_all_model,
                                                  copy_to_model,
                                                  gather_own_grad,
                                                  gather_sum_grad,
                                                  model_parallel,
                                                  reduce_from_model,
                                                  scatter_sum)


def _num_groups(batch: int, seq: int) -> int:
    """Dispatch groups == the active mesh's device count, halved until it
    divides ``batch * seq`` (the global batch); 1 off a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    g = mesh_size(mesh)
    while g > 1 and (batch * seq) % g:
        g //= 2
    return max(g, 1)


class Experts(nn.Module):
    """The experts' gated-MLP weights, stacked over the expert axis
    (``repro.models.layers.init_expert_mlp``)."""

    #: each parameter's logical axes (``init_expert_mlp``'s)
    AXES = {"w_gate": ("experts", "embed_w", "expert_mlp"),
            "w_up": ("experts", "embed_w", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed_w")}

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt, d, ff, e = dtype_of(cfg), cfg.d_model, cfg.d_ff, cfg.num_experts
        self.w_gate = init_expert_stack(gen, e, d, ff, dt, device)
        self.w_up = init_expert_stack(gen, e, d, ff, dt, device)
        self.w_down = init_expert_stack(gen, e, ff, d, dt, device)


class MoE(nn.Module):
    """Pre-norm MoE MLP with its residual: ``forward(x)`` returns
    ``(x + moe(x), aux_loss)`` (``repro.models.moe.apply_moe``)."""

    #: each parameter's logical axes (``init_moe``'s)
    AXES = {"norm": ("embed",), "router": ("embed_w", "experts")}

    def __init__(self, cfg, gen, device):
        super().__init__()
        if cfg.mlp_activation not in ACTIVATIONS:
            raise NotImplementedError(
                f"{cfg.name}: mlp_activation={cfg.mlp_activation!r} is not "
                f"one of {sorted(ACTIVATIONS)}")
        self.cfg = cfg
        self.act = ACTIVATIONS[cfg.mlp_activation]
        self.norm = ones(cfg.d_model, dtype_of(cfg), device)
        self.router = init_dense(gen, cfg.d_model, cfg.num_experts,
                                 torch.float32, device)
        self.experts = Experts(cfg, gen, device)

    def forward(self, x, sp=None):
        """x (B, S, D) -> (x + moe(x), aux).  With ``sp`` (the train
        step's stream split by positions over ``model``) x is this rank's
        block of the S positions and so is the result; the stream then
        routes in one group a model rank (``_num_groups``: S divides over
        ``model``, so the data rank's tokens do)."""
        cfg = self.cfg
        B, S, D = x.shape
        E, K = cfg.num_experts, cfg.experts_per_token
        group, world = data_parallel()
        mgroup, n_model, m = model_parallel()
        if sp is not None:
            S *= n_model
        T = B * S
        G = max(1, _num_groups(B * world, S) // world)
        Tg = T // G
        C = max(1, int(math.ceil(Tg * K / E * cfg.moe_capacity_factor)))
        h = rmsnorm(x, copy_to_model(self.norm, sp), cfg.norm_eps)
        if n_model > 1 and G == n_model:
            combined, aux = self._expert_parallel(h, C, group, world,
                                                  mgroup, n_model, m, sp)
            return x + combined, aux
        ht = h.reshape(T, D)
        dev = x.device
        # fewer groups than model ranks with the experts split: every
        # rank routes every group, so the router's gradient is whole on
        # each (gather_own_grad)
        split = n_model > 1 and self.experts.w_gate.shape[0] != E
        router = gather_own_grad(self.router, mgroup, 1) if split \
            else self.router

        # route: float32 router, softmax, top-k, renormalised gates
        probs, gate_w, expert_idx = self._route(ht, router)
        if split:
            combined = self._few_groups(ht, gate_w, expert_idx, G, C,
                                        mgroup, n_model, m)
        elif G == 1:
            combined = self._group(ht, gate_w, expert_idx, C)
        else:
            combined = torch.cat([
                self._group(ht[i:i + Tg], gate_w[i:i + Tg],
                            expert_idx[i:i + Tg], C)
                for i in range(0, T, Tg)])

        # Switch-style load-balance auxiliary loss
        me = probs.mean(dim=0)
        top1 = probs.argmax(dim=-1)
        counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
            0, top1, torch.ones(T, dtype=torch.float32, device=dev))
        if world > 1:
            dist.all_reduce(counts, group=group)
        ce = counts / (T * world)
        aux = E * torch.sum(me * ce)
        return x + combined.reshape(B, S, D).to(x.dtype), aux

    def _expert_parallel(self, h, C, group, world, mgroup, n, m, sp=None):
        """The block over ``model`` (JAX's ``shard_map`` groups): this
        rank routes its group ``m`` of its data rank's rows h (B, S, D;
        with ``sp`` this rank's block of the positions, gathered along the
        sequence) through the router gathered whole, and the load
        statistics are
        summed over ``mgroup`` (and the counts over ``group``, ``data``)
        so that every model rank has the same auxiliary loss.  With the
        experts split, the packed (E, C, D) buffer is exchanged with the
        model group (block j to rank j, which holds experts j * E / n
        on), each rank runs its own experts over every rank's slots, and
        the outputs are exchanged back; with the experts whole, each rank
        runs them all on its own slots.  The combined rows are gathered
        over ``mgroup`` (with ``sp``, placed in zeros and reduce-scattered
        along the sequence to this rank's positions).  Returns (combined
        (B, S, D), S this rank's positions, in h's dtype; aux)."""
        cfg = self.cfg
        hw = copy_to_model(h, mgroup) if sp is None \
            else gather_sum_grad(h, sp, 1)
        B, S, D = hw.shape
        E = cfg.num_experts
        T = B * S
        Tg = T // n
        dev = h.device
        w = self.experts
        split = w.w_gate.shape[0] != E
        ht = hw.reshape(T, D)[m * Tg:(m + 1) * Tg]
        router = gather_sum_grad(self.router, mgroup, 1) if split \
            else copy_to_model(self.router, mgroup)
        probs, gate_w, expert_idx = self._route(ht, router)

        # the load statistics of the whole data rank's rows on every rank
        top1 = probs.argmax(dim=-1)
        counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
            0, top1, torch.ones(Tg, dtype=torch.float32, device=dev))
        stat = reduce_from_model(torch.stack([probs.sum(dim=0), counts]),
                                 mgroup)
        me, counts = stat[0] / T, stat[1].detach().clone()
        if world > 1:
            dist.all_reduce(counts, group=group)
        aux = E * torch.sum(me * (counts / (T * world)))

        xs, info = self._dispatch(ht, gate_w, expert_idx, C)
        if split:
            El = E // n
            xs = all_to_all_model(xs, mgroup).view(n, El, C, D)
            out = self._experts(xs.transpose(0, 1).reshape(El, n * C, D),
                                (w.w_gate, w.w_up, w.w_down))
            out = out.view(El, n, C, D).transpose(0, 1).reshape(E, C, D)
            out_e = all_to_all_model(out, mgroup)
        else:
            out_e = self._experts(xs, [copy_to_model(t, mgroup) for t in
                                       (w.w_gate, w.w_up, w.w_down)])
        combined = self._combine(out_e.reshape(E * C, D), info,
                                 expert_idx).to(h.dtype)
        if sp is None:
            return gather_own_grad(combined, mgroup, 0).reshape(B, S, D), aux
        rows = Fn.pad(combined, (0, 0, m * Tg, T - (m + 1) * Tg))
        return scatter_sum(rows.reshape(B, S, D), sp, 1), aux

    def _few_groups(self, ht, gate_w, expert_idx, G, C, mgroup, n, m):
        """The block over ``model`` when this data rank's rows route in
        ``G`` groups, fewer than the ``n`` model ranks (JAX leaves
        ``shard_map`` and its ``constrain`` still splits the expert
        products): every rank has routed every group of ``ht`` (T, D);
        it packs each group's (E, C, D) buffer from ``ht`` read through
        ``copy_to_model`` (its gradient is this rank's experts' share),
        runs its own E / n experts over every group's slots, gathers the
        outputs over ``mgroup`` along the experts (the combine is
        replicated, so each rank's gradient of them is whole) and
        combines per group.  No all-to-all.  Returns the float32 (T, D)."""
        T, D = ht.shape
        E = self.cfg.num_experts
        El, Tg = E // n, T // G
        w = self.experts
        hc = copy_to_model(ht, mgroup)
        packed = [self._dispatch(hc[i:i + Tg], gate_w[i:i + Tg],
                                 expert_idx[i:i + Tg], C)
                  for i in range(0, T, Tg)]
        xs = torch.stack([xs for xs, _ in packed])[:, m * El:(m + 1) * El]
        out = self._experts(xs.transpose(0, 1).reshape(El, G * C, D),
                            (w.w_gate, w.w_up, w.w_down))
        out_e = gather_own_grad(out.view(El, G, C, D), mgroup, 0)
        return torch.cat([
            self._combine(out_e[:, g].reshape(E * C, D), info,
                          expert_idx[g * Tg:(g + 1) * Tg])
            for g, (_, info) in enumerate(packed)])

    def _route(self, ht, router):
        """probs (T, E) of the float32 router and softmax, the top-k
        gates renormalised and their experts (T, K)."""
        probs = torch.softmax(ht.float() @ router, dim=-1)          # (T, E)
        gate_w, expert_idx = torch.topk(probs, self.cfg.experts_per_token,
                                        dim=-1)                      # (T, K)
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True),
                                      min=1e-9)
        return probs, gate_w, expert_idx

    def _group(self, ht, gate_w, expert_idx, C):
        """One dispatch group: its tokens ht (T, D) with their top-k gates
        and experts (T, K) -> the float32 combine of their experts'
        outputs (T, D)."""
        w = self.experts
        xs, info = self._dispatch(ht, gate_w, expert_idx, C)
        out_e = self._experts(xs, (w.w_gate, w.w_up, w.w_down))
        return self._combine(out_e.reshape(-1, ht.shape[1]), info,
                             expert_idx)

    def _dispatch(self, ht, gate_w, expert_idx, C):
        """The group's (token, choice) pairs stable-sorted by expert id and
        packed into xs (E, C, D), overflow dropped; and what the combine
        needs (the sort order, the sorted gates, each pair's buffer row
        and whether it was kept)."""
        T, D = ht.shape
        E, K = self.cfg.num_experts, self.cfg.experts_per_token
        dev = ht.device
        flat_e = expert_idx.reshape(-1)
        flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
        order = torch.argsort(flat_e, stable=True)
        se, stok, sw = flat_e[order], flat_tok[order], gate_w.reshape(-1)[order]
        counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
            0, se, torch.ones_like(se))
        group_start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(T * K, device=dev) - group_start[se]
        keep = pos < C
        dst = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))
        # the drop row E*C takes every overflow pair and is sliced off
        buf = torch.zeros(E * C + 1, D, dtype=ht.dtype, device=dev)
        xs = buf.index_put((dst,), ht[stok])[:E * C].view(E, C, D)
        return xs, (order, sw, dst, keep)

    def _experts(self, xs, weights):
        """The experts' gated MLPs over their slots xs (e, rows, D), the
        weights (w_gate, w_up, w_down) of those e experts."""
        w_gate, w_up, w_down = weights
        hidden = self.act(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)
        return torch.bmm(hidden, w_down)

    def _combine(self, out_e, info, expert_idx):
        """The float32 combine (T, D) of the experts' outputs out_e
        (E * C, D); each token sums its K contributions in ascending
        expert order, the sorted order of the JAX scatter-add."""
        order, sw, dst, keep = info
        T, K = expert_idx.shape
        D = out_e.shape[1]
        dev = out_e.device
        got = torch.where(keep[:, None],
                          out_e[torch.clamp(dst, max=out_e.shape[0] - 1)],
                          torch.zeros((), dtype=out_e.dtype, device=dev))
        contrib = got.float() * sw[:, None]
        slot = torch.empty_like(order)
        slot[order] = torch.arange(T * K, device=dev)
        by_rank = contrib[slot].view(T, K, D)          # top-k rank order
        by_expert = by_rank.gather(
            1, torch.argsort(expert_idx, dim=-1)[..., None].expand(T, K, D))
        combined = torch.zeros(T, D, dtype=torch.float32, device=dev)
        for j in range(K):
            combined = combined + by_expert[:, j]
        return combined
