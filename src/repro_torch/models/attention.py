"""GQA self-attention block (port of ``repro.models.attention.attn_block``
in its ``prefill`` and ring ``decode`` modes).

The attention itself goes through ``kernels.ops``: K3 (flash) for the
prefill, K1 (decode) for each generated token.  The KV cache is the
engine's ring buffer (B, S, KV, hd), updated **in place**: where the JAX
package donates the cache and gets a new one back, this block writes the
new K/V into the caller's buffer.
"""

from __future__ import annotations

from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import (dense, dtype_of, init_dense, ones,
                                       rmsnorm, rope)


class Attention(nn.Module):
    """Pre-norm GQA attention with its residual."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt, d = dtype_of(cfg), cfg.d_model
        self.cfg = cfg
        self.norm = ones(d, dt, device)
        self.wq = init_dense(gen, d, cfg.attn_dim, dt, device)
        self.wk = init_dense(gen, d, cfg.kv_dim, dt, device)
        self.wv = init_dense(gen, d, cfg.kv_dim, dt, device)
        self.wo = init_dense(gen, cfg.attn_dim, d, dt, device,
                             scale=cfg.attn_dim ** -0.5)

    def _project_qkv(self, h, rope_cs):
        cfg = self.cfg
        B, S, _ = h.shape
        q = dense(h, self.wq).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = dense(h, self.wk).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = dense(h, self.wv).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        return rope(q, *rope_cs), rope(k, *rope_cs), v

    def prefill(self, x, rope_cs, cache_k, cache_v):
        """Causal attention over the whole (padded) prompt x (B, S, D) at
        positions 0..S-1 (``rope_cs``: their RoPE tables); writes its K/V
        into slots [0, S) of the ring buffers."""
        B, S, _ = x.shape
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        out = ops.flash_attention(q, k, v, causal=True)
        cache_k[:, :S] = k
        cache_v[:, :S] = v
        return x + dense(out.reshape(B, S, -1), self.wo)

    def decode(self, x, rope_cs, t, slot, cache_k, cache_v):
        """One token x (B, 1, D) at absolute position ``t`` (an int32 tensor
        on the device; ``rope_cs``: its RoPE tables): its K/V land at ring
        slot ``slot`` (= t % S, an int64 (1,) tensor) and it attends
        slots <= t."""
        B = x.shape[0]
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        cache_k.index_copy_(1, slot, k)
        cache_v.index_copy_(1, slot, v)
        out = ops.decode_attention(q, cache_k, cache_v, t)
        return x + dense(out.reshape(B, 1, -1), self.wo)
