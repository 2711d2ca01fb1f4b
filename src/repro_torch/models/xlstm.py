"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): a copy
of ``repro.models.xlstm`` in plain PyTorch.

* mLSTM -- exponential-gated linear attention with a matrix state C
  (hd x hd per head).  Training and prefill use the chunkwise-parallel
  form: the recurrence runs across chunks of ``MLSTM_CHUNK`` positions
  (the carry is the (C, n, m) state), attention inside a chunk is
  quadratic with log-space gate-decay weights.  The last chunk is padded
  with input gate -1e9 and forget gate 30 (log-sigmoid ~0: the state
  passes through unchanged).  Decode is the exact one-token recurrence.
* sLSTM -- per-channel scalar memory with block-diagonal (per-head)
  recurrent gate matrices.  The input-side gate projections of every
  position are one product; the recurrence is a per-token loop.

Both keep the gates in log space with a running max ``m`` as the
stabiliser (initially -1e30).  As in the reference, the gate weights
``wi``, ``wf``, ``w_gates``, ``r_gates`` and ``b_gates`` are float32 in
any model dtype, q/k/v and every state are float32, and each block
carries its own up/down projection with the tanh GELU between them (not
gated).

In the train step over ``model`` (``sharding.tensor_parallel``) each
rank runs whole heads: the mLSTM's projections are cut by heads, and the
sLSTM's input-side gate product, whose block of columns holds some of
the four gates of every head, is exchanged into all four gates of this
rank's heads before the token loop; ``wo_out`` and ``down`` are
row-split and summed, ``up`` column-split.  Where the heads do not divide
over ``model`` while the projections do, the split projections are
gathered whole, every rank runs every head and takes its own columns of
the output into its ``wo_out`` rows.

The reference has no Pallas kernel here, only jnp, and the port has no
hand-written kernel either: a fused xLSTM scan would be a later
optimisation.  States are written into the caller's cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from repro_torch.models.layers import (dense, dtype_of, init_dense, ones,
                                       remat, rmsnorm)
from repro_torch.sharding.tensor_parallel import (copy_to_model, from_stream,
                                                  gather_sum_grad, group_for,
                                                  model_parallel,
                                                  own_channels, to_stream)

MLSTM_CHUNK = 256
NEG_INIT = -1e30        # the stabiliser's initial value


def _gelu(x):
    """``jax.nn.gelu`` (its default is the tanh form)."""
    return Fn.gelu(x, approximate="tanh")


class _XLSTMBase(nn.Module):
    """What both blocks share: the pre-norm, the float32 output
    projection back to the model's dtype and the ungated up/down channel
    mixer.  Parameters carry the JAX leaves' names at the block's top
    level (``blocks.<i>.wq``), as ``repro.models.transformer.init_block``
    returns them."""

    #: the shared parameters' logical axes (``init_mlstm``'s and
    #: ``init_slstm``'s)
    AXES = {"norm": ("embed",), "norm2": ("embed",),
            "wo_out": ("qkv", "embed_w"), "up": ("embed_w", "mlp"),
            "down": ("mlp", "embed_w")}

    def _init_common(self, cfg, device):
        dt, d = dtype_of(cfg), cfg.d_model
        self.cfg = cfg
        self.norm = ones(d, dt, device)
        self.norm2 = ones(d, dt, device)

    def _init_out(self, cfg, gen, device):
        dt, d, ad = dtype_of(cfg), cfg.d_model, cfg.attn_dim
        self.wo_out = init_dense(gen, ad, d, dt, device, scale=ad ** -0.5)
        self.up = init_dense(gen, d, d, dt, device)
        self.down = init_dense(gen, d, d, dt, device)

    def _normed(self, x, sp=None):
        """(norm(x), the ``model`` group when the mixer's heads are split
        over it: ``wo_out`` a block of its rows), the normed input's
        gradient summed over the group; with ``sp`` (x this rank's block
        of the positions) gathered along the sequence
        (``tensor_parallel.from_stream``)."""
        group = group_for(self.wo_out.shape[0] != self.cfg.attn_dim)
        h = rmsnorm(x, copy_to_model(self.norm, sp), self.cfg.norm_eps)
        return from_stream(h, group, sp), group

    def _out(self, x, out, group, sp=None):
        """The residual of the mixer's float32 output (B, S, H, hd), H
        this rank's heads (or (B, S, c), this rank's c columns of every
        head's): the row-split products summed over ``group``, with
        ``sp`` reduce-scattered to this rank's positions."""
        out = out.reshape(*out.shape[:2], -1).to(x.dtype)
        return x + to_stream(dense(out, self.wo_out), group, sp)

    def _own_columns(self, out):
        """This rank's ``wo_out`` rows' columns of the output of every
        head (B, S, H, hd), where the heads fall across ranks."""
        c = self.wo_out.shape[0]
        r = model_parallel()[2]
        return out.reshape(*out.shape[:2], -1)[..., r * c:(r + 1) * c]

    def channel_mix(self, x, sp=None):
        """(x + down(gelu(up(norm2(x)))), no auxiliary loss); with ``up``
        column-split over ``model``, ``down``'s row-split products
        summed (with ``sp`` as :meth:`_normed` and :meth:`_out`)."""
        group = group_for(self.up.shape[1] != self.cfg.d_model)
        h2 = from_stream(rmsnorm(x, copy_to_model(self.norm2, sp),
                                 self.cfg.norm_eps), group, sp)
        y = dense(_gelu(dense(h2, self.up)), self.down)
        return x + to_stream(y, group, sp), None

    def forward(self, x, rope_cs=None, image_embeds=None, sp=None):
        """Training (mode ``"train"``): x (B, S, D) -> (x, None); with
        ``sp`` x is this rank's block of the positions, and so is the
        result."""
        x, _ = self.mix(x, sp=sp)
        return self.channel_mix(x, sp)


# ===========================================================================
# mLSTM
# ===========================================================================

def _mlstm_chunk(C, n, m, qq, kk, vv, ii, ff):
    """One chunk of the chunkwise-parallel mLSTM: qq, kk, vv (B, L, H, hd)
    and ii, ff (B, L, H), all float32, from state (C, n, m) -> (C, n, m)
    at the chunk's end and its output (B, L, H, hd)."""
    L = qq.shape[1]
    logf = Fn.logsigmoid(ff)                               # (B,L,H)
    F = torch.cumsum(logf, dim=1)                          # inclusive
    # intra-chunk log weights w[t,s] = F_t - F_s + i_s for s <= t
    w = F[:, :, None, :] - F[:, None, :, :] + ii[:, None, :, :]  # (B,t,s,H)
    tmask = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                  device=qq.device))[None, :, :, None]
    w = torch.where(tmask, w, torch.full_like(w, NEG_INIT))
    m_intra = w.amax(dim=2)                                # (B,L,H)
    m_inter = F + m[:, None, :]                            # (B,L,H)
    m_t = torch.maximum(m_intra, m_inter)
    # intra attention
    logits = torch.einsum("blhd,bshd->blsh", qq, kk)
    wexp = torch.exp(w - m_t[:, :, None, :])
    num = torch.einsum("blsh,bshd->blhd", logits * wexp, vv)
    den = (logits * wexp).sum(dim=2)
    # inter (carry) contribution
    scale_in = torch.exp(m_inter - m_t)                    # (B,L,H)
    num = num + scale_in[..., None] * torch.einsum("blhd,bhde->blhe", qq, C)
    den = den + scale_in * torch.einsum("blhd,bhd->blh", qq, n)
    out = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # state update to the end of the chunk
    FL = F[:, -1:, :]                                      # (B,1,H)
    m_state = torch.maximum(FL[:, 0] + m, (FL - F + ii).amax(dim=1))
    sw = torch.exp(FL - F + ii - m_state[:, None, :])      # (B,L,H)
    decay = torch.exp(FL[:, 0] + m - m_state)              # (B,H)
    C_new = decay[..., None, None] * C + \
        torch.einsum("blh,blhd,blhe->bhde", sw, kk, vv)
    n_new = decay[..., None] * n + torch.einsum("blh,blhd->bhd", sw, kk)
    return C_new, n_new, m_state, out


def mlstm_chunked(q, k, v, i_pre, f_pre, state=None,
                  chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilised mLSTM.

    q, k, v: (B, S, H, hd) float32; i_pre, f_pre: (B, S, H).  state:
    optional (C (B, H, hd, hd), n (B, H, hd), m (B, H)).  Returns (out
    (B, S, H, hd), (C, n, m)).  Each chunk is recomputed in the backward
    pass (the reference's ``jax.checkpoint``)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (Fn.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        i_pre = Fn.pad(i_pre, (0, 0, 0, pad), value=-1e9)
        f_pre = Fn.pad(f_pre, (0, 0, 0, pad), value=30.0)
    if state is None:
        f32 = dict(dtype=torch.float32, device=q.device)
        C = torch.zeros(B, H, hd, hd, **f32)
        n = torch.zeros(B, H, hd, **f32)
        m = torch.full((B, H), NEG_INIT, **f32)
    else:
        C, n, m = state
    outs = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        C, n, m, out = remat(_mlstm_chunk, C, n, m, q[:, sl], k[:, sl],
                             v[:, sl], i_pre[:, sl], f_pre[:, sl])
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :S], (C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """Exact sequential mLSTM for one token: q, k, v (B, 1, H, hd),
    i_pre, f_pre (B, 1, H) -> (out (B, 1, H, hd), (C, n, m))."""
    C, n, m = state
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]                 # (B,H,hd)
    logf = Fn.logsigmoid(f_pre[:, 0])                      # (B,H)
    i1 = i_pre[:, 0]
    m_new = torch.maximum(logf + m, i1)
    fprime = torch.exp(logf + m - m_new)
    iprime = torch.exp(i1 - m_new)
    C_new = fprime[..., None, None] * C + iprime[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k1, v1)
    n_new = fprime[..., None] * n + iprime[..., None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, C_new)
    den = torch.einsum("bhd,bhd->bh", q1, n_new)
    out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return out[:, None], (C_new, n_new, m_new)


class MLSTMBlock(_XLSTMBase):
    """The mLSTM block (``init_mlstm`` / ``mlstm_block``)."""

    AXES = {**_XLSTMBase.AXES, "wq": ("embed_w", "qkv"),
            "wk": ("embed_w", "qkv"), "wv": ("embed_w", "qkv"),
            "wi": ("embed_w", "heads"), "wf": ("embed_w", "heads")}

    def __init__(self, cfg, gen, device):
        super().__init__()
        self._init_common(cfg, device)
        dt, d, ad, H = dtype_of(cfg), cfg.d_model, cfg.attn_dim, \
            cfg.num_heads
        self.wq = init_dense(gen, d, ad, dt, device)
        self.wk = init_dense(gen, d, ad, dt, device)
        self.wv = init_dense(gen, d, ad, dt, device)
        self.wi = init_dense(gen, d, H, torch.float32, device)
        self.wf = init_dense(gen, d, H, torch.float32, device)
        self._init_out(cfg, gen, device)

    def _qkvif(self, h, weights=None):
        """q, k, v (B, S, H, hd) and the gates' pre-activations (B, S, H),
        H this module's heads (read from ``wq``'s width), or those of
        ``weights`` (wq, wk, wv, wi, wf) when given."""
        B, S, _ = h.shape
        hd = self.cfg.head_dim
        wq, wk, wv, wi, wf = weights or (self.wq, self.wk, self.wv,
                                         self.wi, self.wf)
        H = wq.shape[1] // hd
        scale = hd ** -0.5
        q = dense(h, wq).reshape(B, S, H, hd).float() * scale
        k = dense(h, wk).reshape(B, S, H, hd).float() * scale
        v = dense(h, wv).reshape(B, S, H, hd).float()
        h32 = h.float()
        return q, k, v, h32 @ wi, h32 @ wf

    def mix(self, x, state=None, sp=None):
        """x (B, S, D) -> (x + the mixer's output, (C, n, m)).  Without
        ``state`` the chunkwise form from zero states (train, prefill);
        with it one exact step (decode, S = 1).  Over ``model`` each rank
        runs its own heads; where they fall across ranks (``wi`` whole
        while ``wq`` is split) ``wq``/``wk``/``wv`` are gathered whole,
        ``wi``/``wf`` read through ``copy_to_model``, every rank runs
        every head and keeps its own columns."""
        h, group = self._normed(x, sp)
        apart = group is not None and self.wi.shape[1] == self.cfg.num_heads
        weights = None
        if apart:
            weights = [gather_sum_grad(w, group, 1)
                       for w in (self.wq, self.wk, self.wv)] + [
                copy_to_model(w, group) for w in (self.wi, self.wf)]
        q, k, v, i_pre, f_pre = self._qkvif(h, weights)
        if state is None:
            out, state = mlstm_chunked(q, k, v, i_pre, f_pre)
        else:
            out, state = mlstm_step(q, k, v, i_pre, f_pre, state)
        if apart:
            out = self._own_columns(out)
        return self._out(x, out, group, sp), state


# ===========================================================================
# sLSTM
# ===========================================================================

def _slstm_cell(r_gates, b_gates, wx_t, c, n, h, m):
    """One sLSTM step: wx_t (B, 4, H, hd) the input projections of the
    position, states (B, H, hd) -> the new (c, n, h, m)."""
    H, hd = h.shape[1], h.shape[2]
    rec = torch.einsum("bhd,ghde->bghe", h, r_gates)       # (B,4,H,hd)
    pre = wx_t + rec + b_gates.reshape(1, 4, H, hd)
    z = torch.tanh(pre[:, 0])
    i_pre, f_pre, o_pre = pre[:, 1], pre[:, 2], pre[:, 3]
    logf = Fn.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    iprime = torch.exp(i_pre - m_new)
    fprime = torch.exp(logf + m - m_new)
    c_new = fprime * c + iprime * z
    n_new = fprime * n + iprime
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


class SLSTMBlock(_XLSTMBase):
    """The sLSTM block (``init_slstm`` / ``slstm_block``)."""

    AXES = {**_XLSTMBase.AXES, "w_gates": ("embed_w", "qkv"),
            "r_gates": (None, "heads", "head_dim", "head_dim"),
            "b_gates": (None, "qkv")}

    def __init__(self, cfg, gen, device):
        super().__init__()
        self._init_common(cfg, device)
        d, ad, H, hd = cfg.d_model, cfg.attn_dim, cfg.num_heads, \
            cfg.head_dim
        f32 = dict(dtype=torch.float32, device=device)
        self.w_gates = init_dense(gen, d, 4 * ad, torch.float32, device)
        self.r_gates = nn.Parameter(
            torch.randn(4, H, hd, hd, generator=gen, **f32) * hd ** -0.5,
            requires_grad=False)
        self.b_gates = nn.Parameter(torch.zeros(4, ad, **f32),
                                    requires_grad=False)
        self._init_out(cfg, gen, device)

    def mix(self, x, state=None, sp=None):
        """x (B, S, D) -> (x + the mixer's output, (c, n, h, m)), the
        recurrence run token by token from ``state`` (zeros and m = -1e30
        when None: train, prefill).  Over ``model`` this rank's block of
        the gate product (4/n of the gates of every head, gate-major) is
        exchanged into all four gates of its own heads, whose recurrence
        then runs with no collective inside the loop.  Where the heads
        fall across ranks (``r_gates`` whole while ``w_gates`` is split)
        ``w_gates`` and ``b_gates`` are gathered whole, ``r_gates`` read
        through ``copy_to_model``, every rank runs every head and keeps
        its own columns."""
        hin, group = self._normed(x, sp)
        B, S, _ = hin.shape
        apart = group is not None \
            and self.r_gates.shape[1] == self.cfg.num_heads
        w_gates, r_gates, b_gates = self.w_gates, self.r_gates, self.b_gates
        if apart:
            w_gates = gather_sum_grad(w_gates, group, 1)
            b_gates = gather_sum_grad(b_gates, group, 1)
            r_gates = copy_to_model(r_gates, group)
        H, hd = r_gates.shape[1], self.cfg.head_dim
        wx = hin.float() @ w_gates
        if group is not None and not apart:
            wx = own_channels(wx, 4, group)
        wx = wx.reshape(B, S, 4, H, hd)
        if state is None:
            z = torch.zeros(B, H, hd, dtype=torch.float32, device=x.device)
            state = (z, z, z, torch.full_like(z, NEG_INIT))
        hs = []
        for s in range(S):
            state = remat(_slstm_cell, r_gates, b_gates, wx[:, s], *state)
            hs.append(state[2])
        out = torch.stack(hs, dim=1)
        if apart:
            out = self._own_columns(out)
        return self._out(x, out, group, sp), state
