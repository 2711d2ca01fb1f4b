"""Mamba-style selective SSM block, Jamba's sequence mixer (port of
``repro.models.ssm``).

The same arithmetic as the JAX package: a causal depthwise conv of width
w over the inner stream (its last w - 1 rows are the conv state), a
projection of the conv output to B, C and a per-token dt (plus a learned
per-channel bias), and the recurrence ``h_t = exp(dt A) h_{t-1} + dt B
x_t``, ``y_t = C h_t + D x_t``, gated by ``silu(z)``.

The sequence is scanned in chunks of ``CHUNK`` positions, as the JAX
``lax.scan`` does: the (B, chunk, d_inner, N) coefficients exist one
chunk at a time (64 MiB a chunk in float32 at jamba's width, batch 1),
and inside a chunk the recurrence is an inclusive associative scan, here
a log-step Hillis-Steele loop (its rounding differs from
``lax.associative_scan``'s in the last bits).  As in the reference, the
last chunk is zero-padded to the chunk length and the returned state is
the one *after* the pad steps: each pad step still decays the state by
``exp(dt A)`` with dt = softplus(0) + softplus(dt_bias), so after a
prefill longer than one chunk that is not a multiple of it the state is
(numerically) zero.  The port reproduces that; it does not repair it.

In the train step over ``model`` (``sharding.tensor_parallel``) each
rank runs its block of ``d_inner``'s channels: its block of ``in_proj``'s
columns is a block of ``[x | z]``, and the product is exchanged into this
rank's channels of both; the conv, the scan and the states are per
channel; the row-split ``x_proj`` product is summed forward and backward
and ``out_proj``'s row-split product is summed.  Where ``d_inner`` does
not divide over ``model`` while ``in_proj``'s 2 x ``d_inner`` does, the
rank's columns of ``in_proj``'s product are gathered whole and every rank
runs every channel through the whole ``out_proj``.

There is no Pallas kernel here in the reference, and the port has none:
plain PyTorch, no host read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch import nn

from repro_torch.models.layers import (dense, dtype_of, init_dense, ones,
                                       remat, rmsnorm)
from repro_torch.sharding.tensor_parallel import (copy_to_model, from_stream,
                                                  gather_own_grad, group_for,
                                                  own_channels,
                                                  reduce_sum_grad, to_stream)

CHUNK = 128


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _coeffs(p, xc, bcd):
    """SSM coefficients of one chunk: xc (B,Ck,di), bcd (B,Ck,2N+1) f32 ->
    dA, dBx (B,Ck,di,N) f32 and C (B,Ck,N)."""
    n = (bcd.shape[-1] - 1) // 2
    Bmat, Cmat, dt_raw = bcd[..., :n], bcd[..., n:2 * n], bcd[..., -1:]
    dt = softplus(dt_raw)[..., None] \
        + softplus(p.dt_bias)[None, None, :, None]            # (B,Ck,di,1)
    A = -torch.exp(p.A_log)                                    # (di, N)
    dA = torch.exp(dt * A[None, None])
    dBx = dt * Bmat[:, :, None, :] * xc.float()[..., None]
    return dA, dBx, Cmat


def _scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1 from a
    zero state: (A_t, B_t) with h_t = A_t h_0 + B_t.  Hillis-Steele: log2
    steps, each combining every position with the one ``off`` before it
    (``(a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2)``)."""
    L, off = a.shape[1], 1
    while off < L:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, off:] = a[:, off:] * a[:, :-off]
        b_new[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        a, b, off = a_new, b_new, off * 2
    return a, b


def _chunk(p, h, xcc, bcdc, out_dtype):
    """One chunk: (h_last (B,di,N) f32, y (B,Ck,di) in ``out_dtype``)."""
    da, dbx, cmat = _coeffs(p, xcc, bcdc)
    a, b = _scan(da, dbx)
    h_all = a * h[:, None] + b
    yc = torch.einsum("bsdn,bsn->bsd", h_all, cmat)
    yc = yc + p.D[None, None, :] * xcc.float()
    return h_all[:, -1], yc.to(out_dtype)


class Mamba(nn.Module):
    """Pre-norm selective-SSM mixer with its residual
    (``repro.models.ssm.init_mamba`` / ``mamba_block``)."""

    #: each parameter's logical axes (``init_mamba``'s)
    AXES = {"norm": ("embed",), "in_proj": ("embed_w", "ssm_inner"),
            "conv_w": ("conv", "ssm_inner"), "x_proj": ("ssm_inner", None),
            "A_log": ("ssm_inner", "ssm_state"), "D": ("ssm_inner",),
            "dt_bias": ("ssm_inner",), "out_proj": ("ssm_inner", "embed_w")}

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt = dtype_of(cfg)
        d, di, n, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                       cfg.ssm_conv_width)
        f32 = dict(dtype=torch.float32, device=device)
        self.eps, self.d_inner = cfg.norm_eps, di
        self.norm = ones(d, dt, device)
        self.in_proj = init_dense(gen, d, 2 * di, dt, device)
        self.conv_w = nn.Parameter(
            (torch.randn(w, di, generator=gen, device=device)
             * w ** -0.5).to(dt), requires_grad=False)
        self.x_proj = init_dense(gen, di, 2 * n + 1, dt, device)
        self.A_log = nn.Parameter(
            torch.log(1.0 + torch.arange(1, n + 1, **f32))
            * torch.ones(di, 1, **f32), requires_grad=False)
        self.D = nn.Parameter(torch.ones(di, **f32), requires_grad=False)
        self.dt_bias = nn.Parameter(torch.zeros(di, **f32),
                                    requires_grad=False)
        self.out_proj = init_dense(gen, di, d, dt, device, scale=di ** -0.5)

    def mix(self, x_in, conv_state=None, ssm_state=None, group=None):
        """The mixer (``repro.models.ssm.mamba_mix``) on normed x_in
        (B, S, D): returns (y (B, S, di) before ``out_proj``, (conv state
        (B, w-1, di), ssm state (B, di, N) f32)).  Without states it
        starts from zeros (a prefill); with them it continues (a decode
        step, S = 1).  With ``group`` (the train step over ``model``) di
        is this rank's block of the channels; without it, a block of
        ``in_proj``'s columns (the channels whole, ``d_inner`` not dividing
        over ``model``) has its product gathered whole, every rank running
        every channel (its gradient this rank's columns: the downstream is
        the same on every rank)."""
        B, S, _ = x_in.shape
        xz = dense(x_in, self.in_proj)
        if group is None and xz.shape[-1] != 2 * self.d_inner:
            xz = gather_own_grad(xz, group_for(True), xz.dim() - 1)
        if group is None:
            xr, z = xz.chunk(2, dim=-1)                         # (B,S,di)
        else:
            xr, z = own_channels(xz, 2, group).unbind(-2)
        di, w = xr.shape[-1], self.conv_w.shape[0]

        # causal depthwise conv, width w
        pad = (torch.zeros(B, w - 1, di, dtype=xr.dtype, device=xr.device)
               if conv_state is None else conv_state.to(xr.dtype))
        xp = torch.cat([pad, xr], dim=1)                        # (B,S+w-1,di)
        xc = sum(xp[:, i:i + S, :] * self.conv_w[i][None, None, :]
                 for i in range(w))
        xc = Fn.silu(xc)
        new_conv = xp[:, S:, :]                                 # last w-1 rows

        bcd = reduce_sum_grad(dense(xc, self.x_proj),
                              group).float()                   # (B,S,2N+1)
        n = (bcd.shape[-1] - 1) // 2
        h = (torch.zeros(B, di, n, dtype=torch.float32, device=xr.device)
             if ssm_state is None else ssm_state)

        # chunks of the sequence, the last zero-padded to the chunk length
        chunk = min(CHUNK, S)
        nchunks = math.ceil(S / chunk)
        npad = nchunks * chunk - S
        if npad:
            xc = Fn.pad(xc, (0, 0, 0, npad))
            bcd = Fn.pad(bcd, (0, 0, 0, npad))
        ys = []
        for c in range(nchunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            h, yc = remat(_chunk, self, h, xc[:, sl], bcd[:, sl],
                          x_in.dtype)
            ys.append(yc)
        y = torch.cat(ys, dim=1)[:, :S]
        return y * Fn.silu(z), (new_conv, h)

    def forward(self, x, conv_state=None, ssm_state=None, sp=None):
        """x (B, S, D) -> (x + out_proj(mix(norm(x))), (conv, ssm)).  With
        ``d_inner`` split over ``model`` (``conv_w`` a block of its
        columns) the normed input's gradient and the row-split
        ``out_proj`` products are summed; with only ``in_proj``'s columns
        split, the normed input's gradient is summed and ``out_proj`` is
        whole.  With ``sp`` x is this rank's block of the positions, the
        normed input gathered along the sequence and the output returned
        to the block (``sharding.tensor_parallel``)."""
        group = group_for(self.conv_w.shape[1] != self.d_inner)
        cols = group_for(self.in_proj.shape[1] != 2 * self.d_inner)
        h = from_stream(rmsnorm(x, copy_to_model(self.norm, sp), self.eps),
                        cols, sp)
        y, states = self.mix(h, conv_state, ssm_state, group)
        return x + to_stream(dense(y, self.out_proj), group, sp), states
