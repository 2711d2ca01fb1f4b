"""Optimizers from scratch: AdamW and Adafactor (port of
``repro.training.optimizer``).

``params`` and ``grads`` are dicts of tensors keyed by the model's
state-dict names (``dict(lm.named_parameters())``).  The arithmetic is the
JAX package's, step for step: the gradient norm is reported before
clipping, clipping scales by ``min(1, clip / max(norm, 1e-9))``, the
moments are kept in ``moment_dtype`` (float32 by default) and computed in
float32, bias correction uses the float32 step, AdamW's weight decay
applies to every parameter (norms included), and each parameter becomes
``(p32 - lr * delta)`` in its own dtype.  Unlike the JAX function, the
parameters and AdamW's moments are updated **in place** (the dicts given
are returned): the model keeps its tensors, and the state is consumed as
the JAX train CLI donates it (``donate_argnums``), so no second copy of
the weights or the moments is made.  The float32 work runs over the
parameters a bounded slice at a time (``CHUNK`` elements; a contiguous
tensor larger than that in flat ranges): elementwise, so the bits are
those of one pass over all of them, while the temporaries stay a few
hundred MiB however large the model (gemma3-4b-edge's 3.88 B parameters
would need ~5 float32 copies of each at once).

Adafactor factors the second moment of every tensor of two or more
dimensions over its last two axes.  The JAX package stacks each block
parameter over the pattern's repeats, so there a per-layer norm weight
is one (repeats, d) matrix and its statistics are factored across
repeats.  The port keeps that: block parameters are grouped by pattern
position and name (``blocks.<part>.<name>`` for a one-block pattern,
``blocks.pos<p>.<part>.<name>`` otherwise; ``period`` is the pattern's
length), stacked over repeats for the update, and their statistics are
held per group.  Its statistics are reduced over each group's whole
gradient; its elementwise update then runs a run of rows at a time, as
AdamW's does (the same bits, ``CHUNK``-sized temporaries).

All of it is plain PyTorch under ``no_grad`` (``torch._foreach_*`` for
AdamW), as the JAX package leaves it to XLA outside any kernel.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

_LAYER = re.compile(r"^blocks\.(\d+)\.")
#: elements of float32 temporaries one pass of the update holds per input
CHUNK = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    kind: str = "adamw"          # adamw | adafactor
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Dict[str, torch.Tensor]   # adamw: first moment | adafactor: row stats
    v: Dict[str, torch.Tensor]   # adamw: second moment | adafactor: col stats


def group_of(name: str, period: int = 1) -> str:
    """Adafactor's group of a parameter: a block parameter's name with its
    layer index dropped (``blocks.3.attn.wq`` -> ``blocks.attn.wq``), or
    replaced by its pattern position when the pattern has ``period`` > 1
    blocks (``blocks.pos3.attn.wq``); any other name is its own group."""
    m = _LAYER.match(name)
    if m is None:
        return name
    pos = "" if period == 1 else f"pos{int(m.group(1)) % period}."
    return f"blocks.{pos}{name[m.end():]}"


def _groups(names, period: int = 1) -> Dict[str, list]:
    """Adafactor's groups -> their parameter names in layer order."""
    out: Dict[str, list] = {}
    for n in names:
        out.setdefault(group_of(n, period), []).append(n)
    return out


def _stacked(tensors: dict, names: list, group: str) -> torch.Tensor:
    if group.startswith("blocks."):
        return torch.stack([tensors[n] for n in names])
    return tensors[names[0]]


def init_opt_state(params: Dict[str, torch.Tensor],
                   cfg: OptConfig, period: int = 1) -> OptState:
    """Zero moments on the parameters' devices, step 0.  ``period``: the
    block pattern's length (Adafactor's groups)."""
    dev = next(iter(params.values())).device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kind == "adamw":
        dt = getattr(torch, cfg.moment_dtype)
        m = {n: torch.zeros_like(p, dtype=dt) for n, p in params.items()}
        v = {n: torch.zeros_like(p, dtype=dt) for n, p in params.items()}
        return OptState(step, m, v)
    if cfg.kind == "adafactor":
        m, v = {}, {}
        for group, names in _groups(params, period).items():
            shape = _stacked(params, names, group).shape
            kw = dict(dtype=torch.float32, device=dev)
            if len(shape) < 2:
                m[group] = torch.zeros(shape, **kw)
                v[group] = torch.zeros((), **kw)
            else:
                m[group] = torch.zeros(shape[:-1], **kw)
                v[group] = torch.zeros(shape[:-2] + shape[-1:], **kw)
        return OptState(step, m, v)
    raise ValueError(cfg.kind)


def opt_state_axes(params_axes: Dict[str, tuple], cfg: OptConfig,
                   period: int = 1) -> OptState:
    """Logical axes of the optimizer state (``repro.training.optimizer.
    opt_state_axes``).  AdamW's moments mirror the parameters.
    Adafactor's statistics are per group: a block group's tensor is the
    stack over repeats, so its axes gain the leading repeat axis (None)
    before the row statistic drops the last axis and the column statistic
    the second to last, as the JAX function does on its stacked tree."""
    if cfg.kind == "adamw":
        return OptState(step=(), m=dict(params_axes), v=dict(params_axes))
    if cfg.kind != "adafactor":
        raise ValueError(cfg.kind)
    m, v = {}, {}
    for group, names in _groups(params_axes, period).items():
        a = params_axes[names[0]]
        if group.startswith("blocks."):
            a = (None, *a)
        m[group] = a[:-1] if len(a) >= 2 else a
        v[group] = (a[:-2] + a[-1:]) if len(a) >= 2 else ()
    return OptState(step=(), m=m, v=v)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _batches(tensors, size: int = CHUNK):
    """Consecutive runs of ``tensors`` of at most ``size`` elements in all
    (a larger tensor alone)."""
    run, n = [], 0
    for t in tensors:
        if run and n + t.numel() > size:
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    norms = [x for run in _batches(list(grads))
             for x in torch._foreach_norm([g.float() for g in run])]
    return torch.linalg.vector_norm(torch.stack(norms))


def _slices(groups, size: int = CHUNK):
    """The elements of ``groups`` (tuples of equally shaped tensors:
    parameter, gradient, moments) as runs of at most ``size`` elements:
    each run a list of tuples of views, a view a flat range of its
    tensor, or the whole tensor when one of its tuple is not
    contiguous."""
    def ranges(group):
        if not all(t.is_contiguous() for t in group):
            return [group]
        return [tuple(t.view(-1)[a:a + size] for t in group)
                for a in range(0, group[0].numel(), size)]
    run, n = [], 0
    for group in groups:
        for piece in ranges(group):
            if run and n + piece[0].numel() > size:
                yield run
                run, n = [], 0
            run.append(piece)
            n += piece[0].numel()
    if run:
        yield run


def _mean(x, dim: int, split=None, keepdim: bool = False):
    """``torch.mean`` of x over ``dim``; with ``split`` = (process group,
    full length), x holds this rank's block of that dimension and the
    mean is the sum over every rank's block (all-reduced) over the full
    length."""
    if split is None:
        return torch.mean(x, dim=dim, keepdim=keepdim)
    from repro_torch.sharding.tensor_parallel import all_reduce
    group, full = split
    return all_reduce(x.sum(dim=dim, keepdim=keepdim), group).div_(full)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: OptConfig, period: int = 1, gnorm=None, split=None):
    """One optimizer step.  Returns (params, new_state, metrics) with
    ``params`` updated in place and metrics {"grad_norm", "lr"} as 0-d
    tensors on the parameters' device (no host synchronisation).
    ``period``: the block pattern's length, as in :func:`init_opt_state`.
    ``gnorm``: the global gradient norm when ``grads`` are shards of it
    (the data-parallel step), else computed here.  ``split`` (Adafactor):
    {parameter name: (dim, process group, full length)} for parameters
    (and gradients) that are this rank's block of dimension ``dim`` (-1 or
    -2) of the whole, split over the ranks of the group (tensor
    parallelism): the factored statistics' means over that dimension sum
    every rank's block, so each rank updates its own block as the whole
    would be."""
    names = list(params)
    if gnorm is None:
        gnorm = global_norm([grads[n] for n in names])
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    step_f = step.float()
    lr = _schedule(cfg, step)

    if cfg.kind == "adamw":
        b1, b2 = cfg.betas
        for run in _slices((params[n], grads[n], state.m[n], state.v[n])
                           for n in names):
            p, g, m, v = zip(*run)
            g = torch._foreach_mul([x.float() for x in g], scale)
            p32 = [x.float() for x in p]
            m_new = torch._foreach_add(
                torch._foreach_mul([x.float() for x in m], b1),
                torch._foreach_mul(g, 1 - b1))
            v_new = torch._foreach_add(
                torch._foreach_mul([x.float() for x in v], b2),
                torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
            mhat = torch._foreach_div(m_new, 1 - b1 ** step_f)
            vhat = torch._foreach_div(v_new, 1 - b2 ** step_f)
            delta = torch._foreach_div(
                mhat, torch._foreach_add(torch._foreach_sqrt(vhat), cfg.eps))
            delta = torch._foreach_add(
                delta, torch._foreach_mul(p32, cfg.weight_decay))
            new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
            for dst, src in zip(p + m + v, new + m_new + v_new):
                dst.copy_(src)
        return params, OptState(step, state.m, state.v), {
            "grad_norm": gnorm, "lr": lr}

    if cfg.kind == "adafactor":
        eps = 1e-30
        decay = 1.0 - (step_f + 1.0) ** -0.8
        new_m, new_v = {}, {}
        for group, gnames in _groups(names, period).items():
            g32 = dict(zip(gnames, torch._foreach_mul(
                [grads[n].float() for n in gnames], scale)))
            g = _stacked(g32, gnames, group)
            p = _stacked(params, gnames, group)
            stacked = group.startswith("blocks.")
            r, c = state.m[group], state.v[group]
            dim, *cut = (split or {}).get(gnames[0], (0,))
            cols = cut if dim == -1 else None
            rows = cut if dim == -2 else None
            if g.dim() < 2:
                v_new = decay * r + (1 - decay) * (g * g)
                new = p.float() - lr * (g / torch.sqrt(v_new + eps))
                params[gnames[0]].copy_(new)
                new_m[group], new_v[group] = v_new, c
                continue
            r_new = decay * r + (1 - decay) * _mean(g * g, -1, cols)
            c_new = decay * c + (1 - decay) * _mean(g * g, -2, rows)
            rc = r_new / torch.clamp(
                _mean(r_new, -1, rows, keepdim=True), min=eps)
            # the elementwise update a run of rows at a time: the bits of
            # one pass, the float32 temporaries CHUNK elements each (a
            # stack of vectors in one pass)
            n = g.shape[-2]
            run = max(1, CHUNK // g[..., :1, :].numel()) \
                if params[gnames[0]].dim() >= 2 else n
            for a in range(0, n, run):
                at = (..., slice(a, a + run), slice(None))
                vhat = rc[..., a:a + run, None] * c_new[..., None, :]
                new = p[at].float() - lr * (g[at] / torch.sqrt(vhat + eps))
                if not stacked:
                    params[gnames[0]][at].copy_(new)
                for i, name in enumerate(gnames if stacked else ()):
                    leaf = params[name]
                    (leaf[at] if leaf.dim() >= 2 else leaf).copy_(new[i])
            new_m[group], new_v[group] = r_new, c_new
        return params, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                      "lr": lr}
    raise ValueError(cfg.kind)
