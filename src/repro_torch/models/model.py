"""The LM (port of ``repro.models.model.LM``): embedding, a plain loop
over the ``block_pattern x repeats`` layers (``models.transformer``),
tied or separate head, the training forward and its sequence-chunked
cross entropy plus the MoE auxiliary loss, prefill (cold, bucketed, with
per-row prompt lengths, or extend onto a cached prefix), one-token decode
over a ring-buffer KV cache or a block-paged pool, and the speculative
W-position verify forward over either.

Caches exist per kind: attention layers hold ring K/V (``KVCache.k``,
``.v``: (attention layers, B, S, KV, hd)); Mamba layers hold a conv state
(``.conv``: (Mamba layers, B, w-1, d_inner), the model's dtype) and an
SSM state (``.ssm``: (Mamba layers, B, d_inner, N), float32).  A
pure-attention stack has no recurrent state and keeps the attention-only
layout.  The block-paged pool, the extend prefill and the verify forward
are attention-cache operations: they refuse a stack with Mamba layers.

The parameters are created with ``requires_grad=False``: serving never
builds a graph.  A train state (``training.train_loop``) turns them on;
the serving calls stay under ``no_grad`` either way."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as Fn
from torch import nn

from repro_torch.models.layers import (dense, dtype_of, init_dense,
                                       matmul_f32, rmsnorm, rope_tables)
from repro_torch.models.layers import remat as _remat
from repro_torch.models.transformer import (ATTN_KINDS, Block,
                                            attention_layers, attention_only,
                                            check_buildable)

LOSS_CHUNK = 512  # sequence-chunked cross entropy (never all f32 logits)
AUX_LOSS_WEIGHT = 0.01


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
    """The decode caches of every layer, updated in place.

    k, v: (attention layers, B, S, KV, hd) ring buffers.  t: int32 tensor
    on the device, the absolute fill level shared by all attention
    layers: 0-d (one level for the batch, the serial path) or (B,) (one
    per sequence, the decode lanes).  Decode writes step t at slot
    ``t % S`` and attends slots <= t (all of them once wrapped).  RoPE
    positions stay absolute.  conv (Mamba layers, B, w-1, d_inner) and
    ssm (Mamba layers, B, d_inner, N) float32 are the Mamba layers'
    recurrent states, None in a stack without Mamba layers.
    """
    k: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def rows(self, n: int) -> "KVCache":
        """The first ``n`` sequences (views; ``t`` must be (B,))."""
        return KVCache(
            k=self.k[:, :n], v=self.v[:, :n], t=self.t[:n],
            conv=None if self.conv is None else self.conv[:, :n],
            ssm=None if self.ssm is None else self.ssm[:, :n])

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


def _chunk_nll(h, w, labels):
    """Summed next-token NLL of one sequence chunk: float32 logits from
    the product, labels < 0 masked."""
    logits = matmul_f32(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(labels >= 0, lse - tgt, torch.zeros_like(lse)).sum()


class LM(nn.Module):
    """Decoder LM over ``cfg.block_pattern``.  Weights are drawn from a
    seeded ``torch.Generator`` on ``device`` with the JAX init's scales
    (the numbers differ from ``jax.random``'s; carry JAX weights across
    with ``bridge.params_from_jax`` + ``load_state_dict`` to compare).  A
    config needing a block the port does not build raises
    ``NotImplementedError`` before any weight is drawn."""

    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        check_buildable(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, dtype_of(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embed = nn.Parameter(
            (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                         device=dev) * cfg.d_model ** -0.5).to(dt),
            requires_grad=False)
        pattern = cfg.block_pattern
        kinds = [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
        self.blocks = nn.ModuleList(Block(cfg, kind, gen, dev)
                                    for kind in kinds)
        # each layer's index among the layers of its cache kind
        self._slot = [sum((k in ATTN_KINDS) == (kind in ATTN_KINDS)
                          for k in kinds[:i]) for i, kind in enumerate(kinds)]
        self.n_attn = attention_layers(cfg)
        self.n_mamba = cfg.num_layers - self.n_attn
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=dt, device=dev), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = init_dense(gen, cfg.d_model, cfg.vocab_size, dt, dev)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int) -> KVCache:
        """Zeroed ring buffers with fill level 0 and zeroed recurrent
        states (``repro.models.model.LM.init_cache``)."""
        cfg = self.cfg
        shape = (self.n_attn, batch_size, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        kw = dict(dtype=dtype_of(cfg), device=self.device)
        cache = KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
                        t=torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        if self.n_mamba:
            m, B, di = self.n_mamba, batch_size, cfg.d_inner
            cache.conv = torch.zeros((m, B, cfg.ssm_conv_width - 1, di), **kw)
            cache.ssm = torch.zeros((m, B, di, cfg.ssm_state_dim),
                                    dtype=torch.float32, device=self.device)
        return cache

    def init_paged_cache(self, batch_size: int, max_len: int, n_pages: int,
                         page_size: int) -> PagedKVCache:
        """Zeroed block-paged caches (``repro.models.model.LM.
        init_paged_cache``): pools of ``n_pages`` pages (page 0 = trash)
        and, for ``batch_size`` lanes, all-zero block tables (every slot
        unallocated, pointing at the trash page) and fill levels."""
        cfg = self.cfg
        if not attention_only(cfg):
            raise ValueError("block-paged KV needs a pure-attention stack, "
                             f"got {cfg.block_pattern}")
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
        """Final-normed hidden states (B, S, D) of the training forward and
        the summed MoE auxiliary loss: every block in train mode at
        positions 0..S-1, each recomputed in the backward pass when
        ``remat`` (JAX ``run_stack``'s per-block checkpoint)."""
        cfg = self.cfg
        rope_cs = rope_tables(torch.arange(tokens.shape[1],
                                           device=self.device),
                              cfg.head_dim, cfg.rope_theta)
        # F.embedding: its gradient is not among the ops PyTorch documents
        # as nondeterministic on the card, so a resumed run repeats a
        # straight one
        x = Fn.embedding(tokens, self.embed)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            x, a = _remat(blk, x, rope_cs) if remat else blk(x, rope_cs)
            if a is not None:
                aux = aux + a
        return rmsnorm(x, self.final_norm, cfg.norm_eps), aux

    def _head_weight(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def forward(self, tokens, remat: bool = True):
        """Training forward (JAX ``LM.forward``): tokens (B, S) int64 on
        the device -> float32 logits (B, S, V), the head's product taken
        to float32 without rounding to the model's dtype."""
        return matmul_f32(self._hidden(tokens, remat)[0],
                          self._head_weight())

    def loss(self, batch, remat: bool = True):
        """Sequence-chunked next-token cross entropy (JAX ``LM.loss``):
        ``batch`` holds "tokens" and "labels" (B, S) int64 on the device,
        labels < 0 masked.  The f32 logits of one ``LOSS_CHUNK`` slice of
        the sequence exist at a time, and each chunk's are recomputed in
        the backward pass.  ``AUX_LOSS_WEIGHT`` times the MoE blocks'
        auxiliary loss is added (0 in a stack without MoE)."""
        labels = batch["labels"]
        h, aux = self._hidden(batch["tokens"], remat)
        w = self._head_weight()
        S = labels.shape[1]
        chunk = min(LOSS_CHUNK, S)
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        for c0 in range(0, S, chunk):
            tot = tot + _remat(_chunk_nll, h[:, c0:c0 + chunk], w,
                               labels[:, c0:c0 + chunk])
        cnt = (labels >= 0).sum().clamp(min=1).float()
        return tot / cnt + AUX_LOSS_WEIGHT * aux

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

        Mamba layers start from zero states and leave theirs, after the
        last token given (pads included), in ``cache.conv``/``.ssm``: a
        stack with Mamba layers prefills at exact length (the engines'
        rule) and refuses an extend prefill.
        """
        B, S = tokens.shape
        cfg = self.cfg
        start = 0
        if cache is None:
            cache = self.init_cache(B, max(S, pad_to or 0))
        else:
            if self.n_mamba:
                raise ValueError("an extend prefill needs a pure-attention "
                                 f"stack (got pattern {cfg.block_pattern})")
            start = int(cache.t)              # one host read per extend
        rope_cs = rope_tables(start + torch.arange(S, device=self.device),
                              cfg.head_dim, cfg.rope_theta)
        x = self.embed[tokens]
        for blk, j in zip(self.blocks, self._slot):
            if blk.is_attn:
                x = blk.attn.prefill(x, rope_cs, cache.k[j], cache.v[j],
                                     start=start)
            else:
                x = self._mamba(blk, j, x, cache, fresh=True)
            x, _ = blk.channel_mix(x)
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
        branch).  Mamba layers step their conv and SSM states in place."""
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
        for blk, j in zip(self.blocks, self._slot):
            if not blk.is_attn:
                x = self._mamba(blk, j, x, cache, fresh=False)
            elif isinstance(cache, PagedKVCache):
                x = blk.attn.decode_paged(x, rope_cs, t, dest, cache.k[j],
                                          cache.v[j], cache.bt)
            else:
                x = blk.attn.decode(x, rope_cs, t, slot, cache.k[j],
                                    cache.v[j])
            x, _ = blk.channel_mix(x)
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
        on the device.  An attention-cache operation: a stack with Mamba
        layers is refused."""
        cfg = self.cfg
        if not attention_only(cfg):
            raise ValueError("speculative verify needs a pure-attention "
                             f"stack (got pattern {cfg.block_pattern})")
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
            x, _ = blk.channel_mix(x)
        return self._head(x)

    @staticmethod
    def _mamba(blk, j, x, cache, fresh: bool):
        """Mamba layer ``j`` of the cache: from zero states (``fresh``, a
        prefill) or from the cached ones (a decode step); the new states
        are written into the cache in place."""
        if fresh:
            x, (conv, ssm) = blk.mamba(x)
        else:
            x, (conv, ssm) = blk.mamba(x, cache.conv[j], cache.ssm[j])
        cache.conv[j].copy_(conv)
        cache.ssm[j].copy_(ssm)
        return x
