"""The LM (port of ``repro.models.model.LM`` for attention-only stacks):
embedding, a plain loop over layers, tied or separate head, the training
forward and its sequence-chunked cross entropy, bucketed prefill (cold,
per-row prompt lengths, or extend onto a cached prefix), one-token decode
over a ring-buffer KV cache or a block-paged pool, and the speculative
W-position verify forward over either.

The parameters are created with ``requires_grad=False``: serving never
builds a graph.  A train state (``training.train_loop``) turns them on;
the serving calls stay under ``no_grad`` either way."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as Fn
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import Attention
from repro_torch.models.layers import (MLP, dense, dtype_of, init_dense,
                                       matmul_f32, rmsnorm, rope_tables)

LOSS_CHUNK = 512  # sequence-chunked cross entropy (never all f32 logits)


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

    k, v: (layers, B, S, KV, hd).  t: int32 tensor on the device, the
    absolute fill level shared by all layers: 0-d (one level for the
    batch, the serial path) or (B,) (one per sequence, the decode lanes).
    Decode writes step t at slot ``t % S`` and attends slots <= t (all of
    them once wrapped).  RoPE positions stay absolute.
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


@dataclass
class PagedKVCache:
    """Block-paged caches of every layer (``LM.init_paged_cache``),
    updated in place.

    k, v: (layers, n_pages, page, KV, hd) physical pools; page 0 is the
    pinned trash page.  bt: (B, P) int32 block table and t: (B,) int32
    fill levels, both shared by every layer: a physical page id selects
    the same page in every layer's pool, and lane b's logical slot s
    lives at in-page slot s % page of page bt[b, s // page].
    """
    k: torch.Tensor
    v: torch.Tensor
    bt: torch.Tensor
    t: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        return self.bt.shape[1] * self.page_size


class Block(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.attn = Attention(cfg, gen, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, x, rope_cs):
        return self.mlp(self.attn(x, rope_cs))


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``) when a graph is being built."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _chunk_nll(h, w, labels):
    """Summed next-token NLL of one sequence chunk: float32 logits from
    the product, labels < 0 masked."""
    logits = matmul_f32(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(labels >= 0, lse - tgt, torch.zeros_like(lse)).sum()


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

    def init_paged_cache(self, batch_size: int, max_len: int, n_pages: int,
                         page_size: int) -> PagedKVCache:
        """Zeroed block-paged caches (``repro.models.model.LM.
        init_paged_cache``): pools of ``n_pages`` pages (page 0 = trash)
        and, for ``batch_size`` lanes, all-zero block tables (every slot
        unallocated, pointing at the trash page) and fill levels."""
        cfg = self.cfg
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        shape = (cfg.num_layers, n_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        kw = dict(dtype=dtype_of(cfg), device=self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        return PagedKVCache(
            k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
            bt=torch.zeros((batch_size, max_len // page_size), **i32),
            t=torch.zeros((batch_size,), **i32))

    # ------------------------------------------------------------- training
    def _hidden(self, tokens, remat: bool):
        """Final-normed hidden states (B, S, D) of the training forward:
        every block in train mode at positions 0..S-1, each recomputed in
        the backward pass when ``remat`` (JAX ``run_stack``'s per-block
        checkpoint)."""
        cfg = self.cfg
        rope_cs = rope_tables(torch.arange(tokens.shape[1],
                                           device=self.device),
                              cfg.head_dim, cfg.rope_theta)
        # F.embedding: its gradient is not among the ops PyTorch documents
        # as nondeterministic on the card, so a resumed run repeats a
        # straight one
        x = Fn.embedding(tokens, self.embed)
        for blk in self.blocks:
            x = _remat(blk, x, rope_cs) if remat else blk(x, rope_cs)
        return rmsnorm(x, self.final_norm, cfg.norm_eps)

    def _head_weight(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def forward(self, tokens, remat: bool = True):
        """Training forward (JAX ``LM.forward``): tokens (B, S) int64 on
        the device -> float32 logits (B, S, V), the head's product taken
        to float32 without rounding to the model's dtype."""
        return matmul_f32(self._hidden(tokens, remat), self._head_weight())

    def loss(self, batch, remat: bool = True):
        """Sequence-chunked next-token cross entropy (JAX ``LM.loss``):
        ``batch`` holds "tokens" and "labels" (B, S) int64 on the device,
        labels < 0 masked.  The f32 logits of one ``LOSS_CHUNK`` slice of
        the sequence exist at a time, and each chunk's are recomputed in
        the backward pass.  A dense stack has no MoE auxiliary loss (the
        JAX loss adds ``AUX_LOSS_WEIGHT`` x 0 for it)."""
        labels = batch["labels"]
        h = self._hidden(batch["tokens"], remat)
        w = self._head_weight()
        S = labels.shape[1]
        chunk = min(LOSS_CHUNK, S)
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        for c0 in range(0, S, chunk):
            tot = tot + _remat(_chunk_nll, h[:, c0:c0 + chunk], w,
                               labels[:, c0:c0 + chunk])
        cnt = (labels >= 0).sum().clamp(min=1).float()
        return tot / cnt

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
                prompt_len=None, cache: Optional[KVCache] = None,
                fill_to: Optional[int] = None):
        """Full-prompt forward building the decode cache.

        tokens: (B, S) int64 on the device.  Returns (last logits (B, V),
        cache).  The ring holds ``max(S, pad_to)`` slots: allocating it at
        ``pad_to`` up front does what the JAX ``_pad_kv`` does after the
        fact (zeros past S).  ``prompt_len`` enables bucketed prefill: the
        tokens are right-padded to a bucket, logits come from position
        ``prompt_len - 1`` and the fill level is reset to ``prompt_len``,
        so decode overwrites the pad slots in order; causal attention
        keeps the pads dead until then.  A host int is shared by the
        batch; a sequence of B ints gives each row its own length (the
        lane back-fill: mixed prompts in one padded batch), and the cache
        then carries (B,) fill levels.

        ``cache`` switches to an *extend* prefill (JAX ``prefill(caches=,
        fill_to=)``): the tokens are a suffix appended at the cache's fill
        level (a 0-d tensor, read once on the host), written into it in
        place and attending the cached prefix.  ``prompt_len`` then counts
        suffix tokens, and the fill level becomes ``fill_to`` (default:
        the old level plus the suffix's length).
        """
        B, S = tokens.shape
        cfg = self.cfg
        start = 0
        if cache is None:
            cache = self.init_cache(B, max(S, pad_to or 0))
        else:
            start = int(cache.t)              # one host read per extend
        rope_cs = rope_tables(start + torch.arange(S, device=self.device),
                              cfg.head_dim, cfg.rope_theta)
        x = self.embed[tokens]
        for i, blk in enumerate(self.blocks):
            x = blk.attn.prefill(x, rope_cs, cache.k[i], cache.v[i],
                                 start=start)
            x = blk.mlp(x)
        if prompt_len is not None and not isinstance(prompt_len, int) \
                and torch.as_tensor(prompt_len).dim():
            lens = torch.as_tensor(prompt_len, dtype=torch.long,
                                   device=self.device).view(B)
            cache.t = (lens if fill_to is None
                       else torch.as_tensor(fill_to, device=self.device)
                       .view(B)).to(torch.int32)
            last = x[torch.arange(B, device=self.device), lens - 1][:, None]
            return self._head(last)[:, 0], cache
        n = S if prompt_len is None else int(prompt_len)
        cache.set_fill(start + n if fill_to is None else int(fill_to))
        return self._head(x[:, n - 1:n])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache: Union[KVCache, PagedKVCache], tokens):
        """One greedy step.  tokens: (B, 1) int64 on the device.  Writes the
        step's K/V into ``cache`` and advances its fill level(s), both in
        place and on the device (no host synchronisation).  Returns logits
        (B, V).

        Over a ring ``KVCache`` with a shared t the step's K/V land at
        slot t % S; with (B,) levels each lane takes its own RoPE position
        and ring slot.  Over a ``PagedKVCache`` lane b writes physical
        page bt[b, t // page] at in-page slot t % page; a lane past its
        window (a stopped lane stepping to the end of its segment) writes
        the trash page instead, so it can never clobber a page that the
        allocator may hand to another lane (JAX ``attn_block``'s paged
        branch)."""
        cfg = self.cfg
        t = cache.t
        B = tokens.shape[0]
        if isinstance(cache, PagedKVCache):
            page, P = cache.page_size, cache.bt.shape[1]
            block = torch.clamp(torch.div(t, page, rounding_mode="floor"),
                                max=P - 1).long()
            pg = cache.bt.gather(1, block[:, None])[:, 0]
            pg = torch.where(t < P * page, pg, torch.zeros_like(pg))
            dest = (pg * page + torch.remainder(t, page)).long()
        elif t.dim():
            slot = (torch.arange(B, device=t.device),
                    torch.remainder(t, cache.max_len).long())
        else:
            slot = torch.remainder(t, cache.max_len).long().view(1)
        rope_cs = rope_tables(t.view(-1, 1) if t.dim() else t.view(1),
                              cfg.head_dim, cfg.rope_theta)
        x = self.embed[tokens]
        for i, blk in enumerate(self.blocks):
            if isinstance(cache, PagedKVCache):
                x = blk.attn.decode_paged(x, rope_cs, t, dest, cache.k[i],
                                          cache.v[i], cache.bt)
            else:
                x = blk.attn.decode(x, rope_cs, t, slot, cache.k[i],
                                    cache.v[i])
            x = blk.mlp(x)
        t.add_(1)
        return self._head(x)[:, 0]

    @torch.no_grad()
    def verify_step(self, cache: Union[KVCache, PagedKVCache], tokens):
        """Speculative verification (JAX ``LM.verify_step``): score W
        consecutive positions in one forward.  tokens: (B, W) int64 on the
        device, the pending token plus K = W - 1 draft tokens per row.
        Token w is written into the cache at its absolute position t + w
        and attends its own causal prefix, so the logits of position w
        are those serial decode would give after consuming the first
        w + 1 tokens.  The fill level is *not* advanced: the caller
        commits the accepted prefix by resetting it, which is also how
        rejected drafts roll back.  Returns logits (B, W, V).

        A ring position past the buffer is dropped, not wrapped; a paged
        position past the window goes to trash page 0.  Everything stays
        on the device."""
        cfg = self.cfg
        t = cache.t
        B, W = tokens.shape
        w = torch.arange(W, dtype=torch.int32, device=t.device)
        pos = t[:, None] + w if t.dim() else t + w       # (B, W) or (W,)
        rope_cs = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        fills = [t + i for i in range(W)]               # shared by layers
        posb = pos.expand(B, W)
        if isinstance(cache, PagedKVCache):
            page, P = cache.page_size, cache.bt.shape[1]
            block = torch.clamp(torch.div(posb, page, rounding_mode="floor"),
                                max=P - 1).long()
            pg = cache.bt.gather(1, block)
            pg = torch.where(posb < P * page, pg, torch.zeros_like(pg))
            dest = (pg * page + torch.remainder(posb, page)).long().view(-1)
        else:
            S = cache.max_len
            write = (torch.arange(B, device=t.device).repeat_interleave(W),
                     torch.remainder(posb, S).long().reshape(-1),
                     (posb < S).reshape(-1, 1, 1))
        x = self.embed[tokens]
        for i, blk in enumerate(self.blocks):
            if isinstance(cache, PagedKVCache):
                x = blk.attn.verify_paged(x, rope_cs, fills, dest, cache.k[i],
                                          cache.v[i], cache.bt)
            else:
                x = blk.attn.verify(x, rope_cs, fills, write, cache.k[i],
                                    cache.v[i])
            x = blk.mlp(x)
        return self._head(x)
