"""Foundational layers (port of ``repro.models.layers``): dense, the
float32-output product of the training logits, RMSNorm, half-split RoPE,
the gated MLP (SwiGLU or GeGLU), the initialisers with the JAX init's
scales (the expert MLPs' stacked weights among them) and the per-block
activation recomputation of training."""

from __future__ import annotations

import contextlib

import torch
from torch import nn
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import current_mesh, current_rules, use_mesh
from repro_torch.sharding.tensor_parallel import (copy_to_model,
                                                  from_stream, group_for,
                                                  to_stream)


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_dense(gen, in_dim: int, out_dim: int, dtype, device,
               scale: float | None = None) -> nn.Parameter:
    """(in, out) weight ~ N(0, 1) * scale (default in_dim ** -0.5)."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn(in_dim, out_dim, generator=gen, device=device) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def init_expert_stack(gen, n: int, in_dim: int, out_dim: int, dtype,
                      device) -> nn.Parameter:
    """(n, in, out) expert weights ~ N(0, 1) * in_dim ** -0.5 (the JAX
    ``init_expert_mlp``'s scales), drawn one expert at a time: only one
    expert's (in, out) matrix exists in float32 at once (a whole
    jamba-width stack, 16 x 4096 x 14336, would be 3.5 GiB)."""
    w = torch.empty(n, in_dim, out_dim, dtype=dtype, device=device)
    if w.is_meta:                           # shapes only: nothing to draw
        return nn.Parameter(w, requires_grad=False)
    for e in range(n):
        w[e] = (torch.randn(in_dim, out_dim, generator=gen, device=device)
                .mul_(in_dim ** -0.5))
    return nn.Parameter(w, requires_grad=False)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``) when a graph is being built.  The recomputation
    runs under the mesh that is active now (``sharding.use_mesh``): on
    the card the backward runs on autograd's device thread, which does
    not see the caller's thread-local mesh."""
    if not torch.is_grad_enabled():
        return fn(*args)
    mesh, rules = current_mesh(), current_rules()

    def contexts():
        return contextlib.nullcontext(), use_mesh(mesh, rules)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)


def ones(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                        requires_grad=False)


def dense(x, w):
    """x @ w.  The result has x's dtype; float32 inputs multiply in full
    float32 (TF32 stays off unless the caller turns it on) and bf16 inputs
    accumulate in float32 inside the GEMM, as the JAX ``dense`` does."""
    return torch.matmul(x, w)


def _mm_f32(a, b):
    """a @ b for 2-D a, b of one dtype, as float32.  A bf16 product on the
    card is one GEMM that accumulates in float32 and writes float32
    (``torch.mm(out_dtype=)``); on the CPU the operands are widened."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """x @ w with a float32 result from operands of a narrower dtype.  The
    backward casts the float32 cotangent to the operands' dtype and
    returns gradients in it, each product summed in float32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        gx = _mm_f32(g2, w.T).to(x.dtype).reshape(x.shape)
        gw = _mm_f32(x2.T, g2).to(w.dtype)
        return gx, gw


def matmul_f32(x, w):
    """x (..., in) @ w (in, out) -> float32 (..., out): the JAX
    ``jnp.matmul(x, w, preferred_element_type=float32)`` of the LM's
    training logits.  Exact float32 autograd for float32 operands."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    return _MatmulF32.apply(x, w)


def rmsnorm(x, w, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the RoPE angles, each (S, 1, head_dim // 2) float32,
    for absolute ``positions`` (S,).  Computed once per forward and shared
    by every layer's q and k."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def rope(x, cos, sin):
    """Half-split RoPE (``repro.models.layers.rope``).  x: (..., S, H, hd);
    cos, sin from :func:`rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


#: the gated MLP's activation by ``cfg.mlp_activation``: ``jax.nn.silu``
#: (SwiGLU) and ``jax.nn.gelu``, whose default is the tanh form (GeGLU)
ACTIVATIONS = {"silu": Fn.silu,
               "gelu": lambda x: Fn.gelu(x, approximate="tanh")}


class MLP(nn.Module):
    """Pre-norm gated MLP (``repro.models.layers.apply_mlp``) with its
    residual: SwiGLU or GeGLU by ``cfg.mlp_activation``."""

    #: each parameter's logical axes (``init_mlp``'s)
    AXES = {"norm": ("embed",), "w_gate": ("embed_w", "mlp"),
            "w_up": ("embed_w", "mlp"), "w_down": ("mlp", "embed_w")}

    def __init__(self, cfg, gen, device):
        super().__init__()
        if cfg.mlp_activation not in ACTIVATIONS:
            raise NotImplementedError(
                f"{cfg.name}: mlp_activation={cfg.mlp_activation!r} is not "
                f"one of {sorted(ACTIVATIONS)}")
        dt, d, ff = dtype_of(cfg), cfg.d_model, cfg.d_ff
        self.act = ACTIVATIONS[cfg.mlp_activation]
        self.eps = cfg.norm_eps
        self.norm = ones(d, dt, device)
        self.w_gate = init_dense(gen, d, ff, dt, device)
        self.w_up = init_dense(gen, d, ff, dt, device)
        self.w_down = init_dense(gen, ff, d, dt, device, scale=ff ** -0.5)
        self.d_ff = ff

    def forward(self, x, sp=None):
        """With ``d_ff`` split over ``model`` (``w_gate`` a block of its
        columns) this rank computes its block of the hidden units and the
        row-split ``w_down`` products are summed; with ``sp`` x is this
        rank's block of the positions, the normed input gathered and the
        products reduce-scattered (``sharding.tensor_parallel``)."""
        group = group_for(self.w_gate.shape[1] != self.d_ff)
        h = from_stream(rmsnorm(x, copy_to_model(self.norm, sp), self.eps),
                        group, sp)
        hidden = self.act(dense(h, self.w_gate)) * dense(h, self.w_up)
        return x + to_stream(dense(hidden, self.w_down), group, sp)
