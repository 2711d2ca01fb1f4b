"""Foundational layers (port of ``repro.models.layers``): dense, RMSNorm,
half-split RoPE, the SwiGLU MLP, and the initialisers with the JAX init's
scales."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as Fn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_dense(gen, in_dim: int, out_dim: int, dtype, device,
               scale: float | None = None) -> nn.Parameter:
    """(in, out) weight ~ N(0, 1) * scale (default in_dim ** -0.5)."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn(in_dim, out_dim, generator=gen, device=device) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def ones(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                        requires_grad=False)


def dense(x, w):
    """x @ w.  The result has x's dtype; float32 inputs multiply in full
    float32 (TF32 stays off unless the caller turns it on) and bf16 inputs
    accumulate in float32 inside the GEMM, as the JAX ``dense`` does."""
    return torch.matmul(x, w)


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


class MLP(nn.Module):
    """Pre-norm SwiGLU MLP with its residual."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt, d, ff = dtype_of(cfg), cfg.d_model, cfg.d_ff
        self.eps = cfg.norm_eps
        self.norm = ones(d, dt, device)
        self.w_gate = init_dense(gen, d, ff, dt, device)
        self.w_up = init_dense(gen, d, ff, dt, device)
        self.w_down = init_dense(gen, ff, d, dt, device, scale=ff ** -0.5)

    def forward(self, x):
        h = rmsnorm(x, self.norm, self.eps)
        hidden = Fn.silu(dense(h, self.w_gate)) * dense(h, self.w_up)
        return x + dense(hidden, self.w_down)
