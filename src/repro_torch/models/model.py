"""The LM (port of ``repro.models.model.LM`` for attention-only stacks):
embedding, a plain loop over layers, tied or separate head, bucketed
prefill and one-token decode over a ring-buffer KV cache."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import (MLP, dense, dtype_of, init_dense,
                                       rmsnorm, rope_tables)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card; raises when no card is present
    and the caller asked for none (the port never drifts onto the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return torch.device("cuda")


@dataclass
class KVCache:
    """Ring-buffer caches of every layer, updated in place.

    k, v: (layers, B, S, KV, hd).  t: int32 0-d tensor on the device, the
    absolute fill level shared by all layers: decode writes step t at slot
    ``t % S`` and attends slots <= t (all of them once wrapped).  RoPE
    positions stay absolute.
    """
    k: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def set_fill(self, t: int) -> None:
        """Reset the fill level (``repro.models.model._set_fill``)."""
        self.t.fill_(t)


class Block(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.attn = Attention(cfg, gen, device)
        self.mlp = MLP(cfg, gen, device)


class LM(nn.Module):
    """Attention-only decoder LM.  Weights are drawn from a seeded
    ``torch.Generator`` on ``device`` with the JAX init's scales (the
    numbers differ from ``jax.random``'s; carry JAX weights across with
    ``bridge.params_from_jax`` + ``load_state_dict`` to compare)."""

    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, dtype_of(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embed = nn.Parameter(
            (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                         device=dev) * cfg.d_model ** -0.5).to(dt),
            requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, gen, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=dt, device=dev), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = init_dense(gen, cfg.d_model, cfg.vocab_size, dt, dev)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int) -> KVCache:
        """Zeroed ring buffers with fill level 0."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        kw = dict(dtype=dtype_of(cfg), device=self.device)
        return KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
                       t=torch.zeros((), dtype=torch.int32,
                                     device=self.device))

    # ------------------------------------------------------------------ head
    def _head(self, x):
        """Final norm + head.  Logits are float32: exact for float32 models;
        a bf16 model's GEMM accumulates in float32 and rounds its output to
        bf16 before the cast (casting the 49152-row head to float32 every
        token would cost more than the product)."""
        h = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.head
        return dense(h, w).float()

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens, pad_to: Optional[int] = None,
                prompt_len: Optional[int] = None):
        """Full-prompt forward building the decode cache.

        tokens: (B, S) int64 on the device.  Returns (last logits (B, V),
        cache).  The ring holds ``max(S, pad_to)`` slots: allocating it at
        ``pad_to`` up front does what the JAX ``_pad_kv`` does after the
        fact (zeros past S).  ``prompt_len`` (host int) enables bucketed
        prefill: the tokens are right-padded to a bucket, logits come from
        position ``prompt_len - 1`` and the fill level is reset to
        ``prompt_len``, so decode overwrites the pad slots in order; causal
        attention keeps the pads dead until then.
        """
        B, S = tokens.shape
        cache = self.init_cache(B, max(S, pad_to or 0))
        cfg = self.cfg
        rope_cs = rope_tables(torch.arange(S, device=self.device),
                              cfg.head_dim, cfg.rope_theta)
        x = self.embed[tokens]
        for i, blk in enumerate(self.blocks):
            x = blk.attn.prefill(x, rope_cs, cache.k[i], cache.v[i])
            x = blk.mlp(x)
        n = S if prompt_len is None else int(prompt_len)
        cache.set_fill(n)
        return self._head(x[:, n - 1:n])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache: KVCache, tokens):
        """One greedy step.  tokens: (B, 1) int64 on the device.  Writes the
        step's K/V into ``cache`` and advances its fill level, both in place
        and on the device (no host synchronisation).  Returns logits
        (B, V)."""
        cfg = self.cfg
        slot = torch.remainder(cache.t, cache.max_len).long().view(1)
        rope_cs = rope_tables(cache.t.view(1), cfg.head_dim, cfg.rope_theta)
        x = self.embed[tokens]
        for i, blk in enumerate(self.blocks):
            x = blk.attn.decode(x, rope_cs, cache.t, slot, cache.k[i],
                                cache.v[i])
            x = blk.mlp(x)
        cache.t.add_(1)
        return self._head(x)[:, 0]
