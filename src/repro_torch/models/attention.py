"""GQA self-attention block (port of ``repro.models.attention.attn_block``,
QK-norm included, in its ``train``, ``prefill`` (cold and extend), ring
``decode``, block-paged ``decode`` and ``verify`` (ring and paged)
modes) and the cross-attention block over image tokens (``xattn_block``).

Training (``forward``) goes through ``ops.flash_attention_train``: K3
forward with its log-sum-exp and K3b backward on the card.

The attention itself goes through ``kernels.ops``: K3 (flash) for every
prefill, K1 (decode) for each generated token over a ring cache, K2
(paged decode) for each generated token over the block-paged pool.  The
speculative verify forward runs K1 or K2 once per verified position
``w`` at fill level ``t + w``: by the JAX ``verify_attention``'s own
contract, its row ``w`` is decode attention at that level with all W new
K/Vs written.  The caches are updated **in place**: where the JAX package
donates a cache and gets a new one back, this block writes the new K/V
into the caller's buffer.

Cross-attention (``CrossAttention``) takes its queries from the text and
its K/V from the image embeddings (no RoPE, no norm on the embeddings):
a prefill projects them into the image cache and attends all of them
through K3 in non-causal mode (Sq prompt rows over Skv image rows); a
decode step reuses the cache and attends it through K1 at fill level
``T_img - 1``, where every slot is live -- the same function with one
query row, spread over K1's cluster split of the image slots.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import (dense, dtype_of, init_dense, ones,
                                       rmsnorm, rope)
from repro_torch.sharding.tensor_parallel import (copy_to_model, from_stream,
                                                  gather_sum_grad, group_for,
                                                  model_parallel, to_stream)


class Attention(nn.Module):
    """Pre-norm GQA attention with its residual."""

    #: each parameter's logical axes (``init_attention``'s)
    AXES = {"norm": ("embed",), "wq": ("embed_w", "qkv"),
            "wk": ("embed_w", "qkv"), "wv": ("embed_w", "qkv"),
            "wo": ("qkv", "embed_w"), "q_norm": ("head_dim",),
            "k_norm": ("head_dim",)}

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
        if cfg.qk_norm:
            self.q_norm = ones(cfg.head_dim, dt, device)
            self.k_norm = ones(cfg.head_dim, dt, device)

    def _project_qkv(self, h, rope_cs, group=None, weights=None):
        """q (B,S,H,hd), k/v (B,S,KV,hd), H and KV this module's heads (its
        block of them when the train step splits the heads over ``model``:
        read from the weights' widths) or those of ``weights`` (wq, wk,
        wv) when given; with ``qk_norm``, q and k are RMS-normed over the
        head dimension before RoPE, the norm weights read through
        ``copy_to_model`` over ``group``.  Every mode goes through here."""
        cfg = self.cfg
        B, S, _ = h.shape
        hd = cfg.head_dim
        wq, wk, wv = weights or (self.wq, self.wk, self.wv)
        q = dense(h, wq).reshape(B, S, wq.shape[1] // hd, hd)
        k = dense(h, wk).reshape(B, S, wk.shape[1] // hd, hd)
        v = dense(h, wv).reshape(B, S, wv.shape[1] // hd, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, copy_to_model(self.q_norm, group), cfg.norm_eps)
            k = rmsnorm(k, copy_to_model(self.k_norm, group), cfg.norm_eps)
        return rope(q, *rope_cs), rope(k, *rope_cs), v

    def _whole_heads(self) -> bool:
        """True when this rank's blocks of ``wq`` and ``wk`` hold whole
        heads, its query heads beside their KV heads."""
        hd, kv = self.cfg.head_dim, self.wk.shape[1]
        return self.wq.shape[1] % hd == 0 and kv % hd == 0 \
            and kv != self.cfg.kv_dim

    def forward(self, x, rope_cs, sp=None):
        """Training (JAX ``attn_block`` mode ``"train"``): causal attention
        over x (B, S, D) at positions 0..S-1 (``rope_cs``: their RoPE
        tables) through ``ops.flash_attention_train``, differentiable; no
        cache.  Over ``model``: :meth:`_train`."""
        return self._train(x, lambda h, group, weights: self._project_qkv(
            h, rope_cs, group, weights), causal=True, sp=sp)

    def _train(self, x, project, causal: bool, sp=None):
        """x plus the block's training attention (K3 forward, K3b
        backward) of the q, k, v that ``project(h, group, weights)``
        gives from the normed x ``h``: ``weights`` (wq, wk, wv) whole when
        given, else this module's own.

        With the heads split over ``model`` (``wq`` a block of its
        columns) the row-split ``wo`` products are summed
        (``sharding.tensor_parallel``).  Where each rank holds whole heads
        it attends its own.  Where a spec cuts inside a head, or ``wk``
        stays whole while ``wq`` is split, the split projections are
        gathered whole (their gradients reduce-scattered; a whole one is
        read through ``copy_to_model``), every rank attends every head
        (as GSPMD gathers q/k/v where ``heads`` does not divide), and
        takes its own columns of the output into its ``wo`` rows.  The
        weights are gathered rather than the activations: a projection
        weight (d_model x width) is smaller than its output (B x S x
        width) once B * S exceeds d_model, as in every train cell.

        With ``sp`` x is this rank's block of the positions: it is normed
        there, the normed input gathered along the sequence and the
        output reduce-scattered back to the block
        (``tensor_parallel.from_stream``, ``to_stream``)."""
        cfg = self.cfg
        n_q = self.wq.shape[1]
        group = group_for(n_q != cfg.attn_dim)
        h = from_stream(rmsnorm(x, copy_to_model(self.norm, sp),
                                cfg.norm_eps), group, sp)
        B, S, _ = h.shape
        weights = None
        if group is not None and not self._whole_heads():
            weights = [gather_sum_grad(w, group, 1) if w.shape[1] != full
                       else copy_to_model(w, group)
                       for w, full in ((self.wq, cfg.attn_dim),
                                       (self.wk, cfg.kv_dim),
                                       (self.wv, cfg.kv_dim))]
        q, k, v = project(h, group, weights)
        out = ops.flash_attention_train(q, k, v, causal=causal)
        out = out.reshape(B, S, -1)
        if weights is not None:
            r = model_parallel()[2]
            out = out[..., r * n_q:(r + 1) * n_q]
        return x + to_stream(dense(out, self.wo), group, sp)

    def prefill(self, x, rope_cs, cache_k, cache_v, start: int = 0):
        """Causal attention over the (padded) tokens x (B, S, D) at
        positions start..start+S-1 (``rope_cs``: their RoPE tables); their
        K/V land in slots [start, start+S) of the buffers.

        ``start`` 0 is a cold prefill: the tokens attend each other only.
        ``start`` > 0 (a host int) is an extend prefill: x is a suffix
        appended to the ``start`` cached prefix slots, its K/V are written
        first and it attends the buffer causally through K3's
        ``q_offset``, so each suffix row sees prefix + suffix exactly as
        it would in a cold prefill of both (JAX ``attn_block``'s extend
        branch)."""
        B, S, _ = x.shape
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        if start == 0:
            out = ops.flash_attention(q, k, v, causal=True)
            cache_k[:, :S] = k
            cache_v[:, :S] = v
        else:
            cache_k[:, start:start + S] = k
            cache_v[:, start:start + S] = v
            out = ops.flash_attention(q, cache_k, cache_v, causal=True,
                                      q_offset=start)
        return x + dense(out.reshape(B, S, -1), self.wo)

    def decode(self, x, rope_cs, t, slot, cache_k, cache_v):
        """One token per row, x (B, 1, D), at absolute position ``t`` (an
        int32 tensor on the device: 0-d shared by the batch, or (B,) per
        lane; ``rope_cs``: its RoPE tables).  Its K/V land at ring slot
        t % S: ``slot`` is that slot as an int64 (1,) tensor for a shared
        t, or the index pair (lanes, slots) for per-lane levels (an index
        scatter, row b into ``cache[b, slots[b]]``).  It attends ring
        slots <= t through K1."""
        B = x.shape[0]
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        if isinstance(slot, tuple):
            cache_k.index_put_(slot, k[:, 0])
            cache_v.index_put_(slot, v[:, 0])
        else:
            cache_k.index_copy_(1, slot, k)
            cache_v.index_copy_(1, slot, v)
        out = ops.decode_attention(q, cache_k, cache_v, t)
        return x + dense(out.reshape(B, 1, -1), self.wo)

    def decode_paged(self, x, rope_cs, t, dest, pool_k, pool_v, bt):
        """One token per lane, x (B, 1, D), over the block-paged pool
        (n_pages, page, KV, hd).  ``dest`` (B,) int64 is each lane's flat
        pool row for this step (bt[b, t // page] * page + t % page, or a
        row of trash page 0 for a lane past its window): the K/V land
        there, then the lane attends logical slots <= t[b] through its
        block-table row ``bt`` with K2, which reads the pool in place."""
        B = x.shape[0]
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        n_pages, page, KV, hd = pool_k.shape
        # duplicate rows only ever hit the trash page (live lanes write
        # pages they own alone), where write order is irrelevant
        pool_k.view(n_pages * page, KV, hd).index_copy_(0, dest, k[:, 0])
        pool_v.view(n_pages * page, KV, hd).index_copy_(0, dest, v[:, 0])
        out = ops.paged_decode_attention(q, pool_k, pool_v, bt, t)
        return x + dense(out.reshape(B, 1, -1), self.wo)

    def verify(self, x, rope_cs, fills, write, cache_k, cache_v):
        """Speculative verification over a ring cache: x (B, W, D) holds
        the pending token and K = W - 1 draft tokens per row at positions
        ``t + w`` (``rope_cs``: their RoPE tables).  All W K/Vs are
        written first, then query row w attends slots <= t + w through
        K1 at ``fills[w]`` (= t + w), so each row sees the draft tokens
        before it through their just-written K/V.  The fill level is not
        advanced; the caller commits the accepted prefix.

        ``write`` = (lanes, slots, keep), each over the B*W positions in
        row-major order: ring slot ``(t + w) % S`` and whether the
        position is inside the ring.  A position past the ring is dropped,
        not wrapped (JAX writes it with ``mode="drop"``): its slot gets
        back the value it holds, so a live early slot is never clobbered
        before its masked read.  In-ring and dropped slots never coincide
        while W <= S, so every slot is written once."""
        B, W, _ = x.shape
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        lanes, slots, keep = write
        for cache, new in ((cache_k, k), (cache_v, v)):
            new = new.reshape(B * W, *new.shape[2:])
            cache.index_put_((lanes, slots),
                             torch.where(keep, new, cache[lanes, slots]))
        out = torch.cat([ops.decode_attention(q[:, w:w + 1], cache_k,
                                              cache_v, fills[w])
                         for w in range(W)], dim=1)
        return x + dense(out.reshape(B, W, -1), self.wo)

    def verify_paged(self, x, rope_cs, fills, dest, pool_k, pool_v, bt):
        """Speculative verification over the block-paged pool: as
        :meth:`verify`, with the W K/Vs of lane b landing at the flat
        pool rows ``dest`` (B*W,) (bt[b, p // page] * page + p % page for
        position p = t[b] + w, or a row of trash page 0 past the window)
        and each query row w attending through the lane's table with K2
        at ``fills[w]``, which reads the pool in place."""
        B, W, _ = x.shape
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        q, k, v = self._project_qkv(h, rope_cs)
        n_pages, page, KV, hd = pool_k.shape
        # duplicate rows only ever hit the trash page (live positions
        # write pages their lane owns alone)
        pool_k.view(n_pages * page, KV, hd).index_copy_(
            0, dest, k.reshape(B * W, KV, hd))
        pool_v.view(n_pages * page, KV, hd).index_copy_(
            0, dest, v.reshape(B * W, KV, hd))
        out = torch.cat([ops.paged_decode_attention(q[:, w:w + 1], pool_k,
                                                    pool_v, bt, fills[w])
                         for w in range(W)], dim=1)
        return x + dense(out.reshape(B, W, -1), self.wo)


class CrossAttention(Attention):
    """Pre-norm cross-attention over image tokens with its residual
    (``init_attention(cross=True)`` / ``xattn_block``): the same leaves
    as :class:`Attention`; Q/K norm only with ``cfg.qk_norm``.  Its
    heads split over ``model`` as :class:`Attention`'s do; the image K/V
    of this rank's heads are projected from the replicated embeddings."""

    def _q(self, h, group=None, weights=None):
        """q (B, S, H, hd) of this module's ``wq`` (or that of ``weights``,
        (wq, wk, wv), when given), H read from the weight's width; with
        ``qk_norm`` normed over the head dimension, the norm weight read
        through ``copy_to_model`` over ``group``."""
        cfg = self.cfg
        B, S, _ = h.shape
        wq = weights[0] if weights else self.wq
        q = dense(h, wq).reshape(B, S, wq.shape[1] // cfg.head_dim,
                                 cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, copy_to_model(self.q_norm, group), cfg.norm_eps)
        return q

    def _kv(self, image_embeds, group=None, weights=None):
        """k, v (B, T_img, KV, hd) projected from the embeddings by this
        module's ``wk``/``wv`` (or those of ``weights``), KV read from
        their widths; k normed as q is with ``qk_norm``."""
        cfg = self.cfg
        B, T, _ = image_embeds.shape
        _, wk, wv = weights or (None, self.wk, self.wv)
        hd = cfg.head_dim
        k = dense(image_embeds, wk).reshape(B, T, wk.shape[1] // hd, hd)
        v = dense(image_embeds, wv).reshape(B, T, wv.shape[1] // hd, hd)
        if cfg.qk_norm:
            k = rmsnorm(k, copy_to_model(self.k_norm, group), cfg.norm_eps)
        return k, v

    def _attend(self, x, q, k, v):
        B, S, _ = x.shape
        out = ops.flash_attention(q, k, v, causal=False)
        return x + dense(out.reshape(B, S, -1), self.wo)

    def forward(self, x, image_embeds, sp=None):
        """Training (mode ``"train"``): x (B, S, D) attends every image
        row, through ``ops.flash_attention_train`` (non-causal); no
        cache.  Over ``model`` as :meth:`Attention._train`: the queries
        from the gathered input, the K/V from the whole embeddings."""
        return self._train(x, lambda h, group, weights: (
            self._q(h, group, weights),
            *self._kv(image_embeds, group, weights)), causal=False, sp=sp)

    def prefill(self, x, image_embeds, cache_k, cache_v):
        """x (B, S, D) attends every image row through K3 (non-causal,
        Sq = S, Skv = T_img); the projected image K/V land in the
        (B, T_img, KV, hd) cache buffers."""
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        k, v = self._kv(image_embeds)
        cache_k.copy_(k)
        cache_v.copy_(v)
        return self._attend(x, self._q(h), k, v)

    def decode(self, x, cache_k, cache_v):
        """One token per row, x (B, 1, D), attends the cached image K/V
        through K1 at fill level T_img - 1 (every slot live)."""
        B = x.shape[0]
        h = rmsnorm(x, self.norm, self.cfg.norm_eps)
        t = torch.full((), cache_k.shape[1] - 1, dtype=torch.int32,
                       device=x.device)
        out = ops.decode_attention(self._q(h), cache_k, cache_v, t)
        return x + dense(out.reshape(B, 1, -1), self.wo)
