"""The LM (port of ``repro.models.model.LM``): embedding (or, with the
audio frontend, the caller's frame embeddings), a plain loop over the
``block_pattern x repeats`` layers (``models.transformer``), tied or
separate head, the training forward and its sequence-chunked cross
entropy plus the MoE auxiliary loss, prefill (cold, bucketed, with
per-row prompt lengths, or extend onto a cached prefix), one-token decode
over a ring-buffer KV cache or a block-paged pool, and the speculative
W-position verify forward over either.

The inputs carry the JAX batch's names: ``tokens`` (B, S) for text,
``frames`` (B, S, D) for the audio frontend (musicgen: no embedding
table), and ``image_embeds`` (B, T_img, D) beside them for a stack with
cross-attention layers (read on prefill and in training; a decode step
reuses the projected image K/V from the cache).

Caches exist per kind, each layer in a slot among the layers of its own
kind: attention layers hold ring K/V (``KVCache.k``, ``.v``: (attention
layers, B, S, KV, hd); empty in a stack without attention layers);
Mamba layers a conv state (``.conv``: (Mamba layers, B, w-1, d_inner),
the model's dtype) and an SSM state (``.ssm``: (Mamba layers, B,
d_inner, N), float32); mLSTM layers ``.mlstm_C`` (n, B, H, hd, hd),
``.mlstm_n`` (n, B, H, hd) and ``.mlstm_m`` (n, B, H); sLSTM layers
``.slstm_c``, ``.slstm_n``, ``.slstm_h`` and ``.slstm_m``, each (n, B,
H, hd), all float32; cross-attention layers the image K/V ``.xk``,
``.xv`` (n, B, T_img, KV, hd), the model's dtype.  The block-paged pool,
the extend prefill and the verify forward are attention-cache
operations: they refuse a stack with any other kind of layer.

The parameters are created with ``requires_grad=False``: serving never
builds a graph.  A train state (``training.train_loop``) turns them on;
the serving calls stay under ``no_grad`` either way."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as Fn
from torch import nn

from repro_torch.models.layers import (dense, dtype_of, init_dense,
                                       matmul_f32, rmsnorm, rope_tables)
from repro_torch.models.layers import remat as _remat
from repro_torch.models.transformer import (attention_only, cache_group,
                                            make_block)
from repro_torch.models.xlstm import NEG_INIT
from repro_torch.sharding import data_parallel
from repro_torch.sharding.tensor_parallel import (all_reduce, copy_to_model,
                                                  from_stream, group_for,
                                                  model_parallel, own_block,
                                                  reduce_from_model,
                                                  seq_parallel,
                                                  vocab_parallel_embedding)

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


#: the per-sequence states each cache group holds beside the ring
STATES = {"mamba": ("conv", "ssm"),
          "mlstm": ("mlstm_C", "mlstm_n", "mlstm_m"),
          "slstm": ("slstm_c", "slstm_n", "slstm_h", "slstm_m"),
          "xattn": ("xk", "xv")}


@dataclass
class KVCache:
    """The decode caches of every layer, updated in place.

    k, v: (attention layers, B, S, KV, hd) ring buffers.  t: int32 tensor
    on the device, the absolute fill level shared by all attention
    layers: 0-d (one level for the batch, the serial path) or (B,) (one
    per sequence, the decode lanes).  Decode writes step t at slot
    ``t % S`` and attends slots <= t (all of them once wrapped).  RoPE
    positions stay absolute.  A stack without attention layers keeps
    empty k, v (0 layers) and still advances t.

    The other fields (``STATES``) are the per-sequence states of the
    other kinds, (layers of the kind, B, ...), None in a stack without
    such layers: the Mamba conv and SSM states, the mLSTM (C, n, m), the
    sLSTM (c, n, h, m) and the cross-attention layers' image K/V.
    """
    k: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    mlstm_C: Optional[torch.Tensor] = None
    mlstm_n: Optional[torch.Tensor] = None
    mlstm_m: Optional[torch.Tensor] = None
    slstm_c: Optional[torch.Tensor] = None
    slstm_n: Optional[torch.Tensor] = None
    slstm_h: Optional[torch.Tensor] = None
    slstm_m: Optional[torch.Tensor] = None
    xk: Optional[torch.Tensor] = None
    xv: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def states(self):
        """(name, tensor) of every per-sequence state the cache holds."""
        return [(n, getattr(self, n)) for names in STATES.values()
                for n in names if getattr(self, n) is not None]

    def rows(self, n: int) -> "KVCache":
        """The first ``n`` sequences (views; ``t`` must be (B,))."""
        return KVCache(k=self.k[:, :n], v=self.v[:, :n], t=self.t[:n],
                       **{name: x[:, :n] for name, x in self.states()})

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


def _chunk_nll_vocab_parallel(h, w, labels, group, rank: int):
    """:func:`_chunk_nll` with the head's columns split over ``group``:
    ``w`` is this rank's block of vocabulary columns (from ``rank *
    w.shape[1]``).  The log-sum-exp's max is all-reduced (a constant of
    the gradient), then its sum of exponentials and the target logit,
    which only the rank owning the label's column contributes."""
    logits = matmul_f32(h, w)
    n = logits.shape[-1]
    with torch.no_grad():
        m = all_reduce(logits.amax(dim=-1), group, dist.ReduceOp.MAX)
    local = labels - rank * n
    own = (local >= 0) & (local < n)
    tgt = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    z = torch.exp(logits - m[..., None]).sum(dim=-1)
    z, tgt = reduce_from_model(torch.stack(
        [z, torch.where(own, tgt, torch.zeros_like(tgt))]), group).unbind(0)
    lse = m + torch.log(z)
    return torch.where(labels >= 0, lse - tgt, torch.zeros_like(lse)).sum()


class LM(nn.Module):
    """Decoder LM over ``cfg.block_pattern``.  Weights are drawn from a
    seeded ``torch.Generator`` on ``device`` with the JAX init's scales
    (the numbers differ from ``jax.random``'s; carry JAX weights across
    with ``bridge.params_from_jax`` + ``load_state_dict`` to compare).
    With ``cfg.audio_frontend`` there is no embedding table.  On the
    ``meta`` device nothing is drawn or allocated: the parameters have
    their shapes and dtypes only (the abstract state of the dry run).

    :meth:`param_axes` and :meth:`cache_axes` give every parameter's and
    cache field's logical axes (``sharding.rules``), each parameter's
    from the module that owns it (``AXES``), as the JAX ``init_*``
    functions return them beside the arrays."""

    #: the top-level parameters' logical axes (``init_model``'s)
    AXES = {"embed": ("vocab", "embed_w"), "final_norm": ("embed",),
            "head": ("embed_w", "vocab")}

    def __init__(self, cfg, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, dtype_of(cfg)
        pattern = cfg.block_pattern
        kinds = [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
        # each layer's cache group and its slot among that group's layers
        self._group = [cache_group(k) for k in kinds]
        self._slot = [self._group[:i].count(g)
                      for i, g in enumerate(self._group)]
        self.n_layers = {g: self._group.count(g) for g in STATES}
        self.n_attn = self._group.count("attn")
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        if not cfg.audio_frontend:
            self.embed = nn.Parameter(
                (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                             device=dev) * cfg.d_model ** -0.5).to(dt),
                requires_grad=False)
        self.blocks = nn.ModuleList(make_block(cfg, kind, gen, dev)
                                    for kind in kinds)
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=dt, device=dev), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = init_dense(gen, cfg.d_model, cfg.vocab_size, dt, dev)

    def param_count_actual(self) -> int:
        """Every parameter counted once (a tied head reads ``embed``), as
        the JAX ``LM.param_count_actual`` sums its tree's leaves; on the
        ``meta`` device nothing is allocated."""
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------------ axes
    def param_axes(self) -> dict:
        """{state-dict name: logical axes} of every parameter, from the
        ``AXES`` of the module that owns it: the JAX ``init_model`` axes of
        the same leaf (``models.bridge`` names) with the stacked repeat
        axis dropped."""
        owner = {}
        for mname, mod in self.named_modules():
            for pname, _ in mod.named_parameters(recurse=False):
                owner[f"{mname}.{pname}" if mname else pname] = \
                    mod.AXES[pname]
        return {n: owner[n] for n, _ in self.named_parameters()}

    def cache_axes(self) -> dict:
        """{``KVCache`` field: logical axes} of the fields
        :meth:`init_cache` fills (the JAX ``LM.cache_axes`` per kind; the
        leading axis counts a kind's layers, the fill level is 0-d)."""
        cfg = self.cfg
        kv = (None, "batch", "kv_seq", "kv_heads", "head_dim")
        cell = (None, "batch", "heads", "head_dim")
        axes = {"k": kv, "v": kv, "t": ()}
        per_kind = {
            "mamba": {"conv": (None, "batch", "conv", "ssm_inner"),
                      "ssm": (None, "batch", "ssm_inner", "ssm_state")},
            "mlstm": {"mlstm_C": (None, "batch", "heads", "head_dim",
                                  "head_dim"),
                      "mlstm_n": cell, "mlstm_m": (None, "batch", "heads")},
            "slstm": {n: cell for n in STATES["slstm"]},
            "xattn": {n: (None, "batch", "image_seq", "kv_heads",
                          "head_dim") for n in STATES["xattn"]}}
        for kind, fields in per_kind.items():
            if self.n_layers[kind]:
                axes.update(fields)
        return axes

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int) -> KVCache:
        """Zeroed ring buffers with fill level 0 and the other kinds'
        initial states (``repro.models.model.LM.init_cache``: zeros, the
        xLSTM stabilisers at -1e30)."""
        cfg = self.cfg
        B, KV, hd, H = batch_size, cfg.num_kv_heads, cfg.head_dim, \
            cfg.num_heads
        kw = dict(dtype=dtype_of(cfg), device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        shape = (self.n_attn, B, max_len, KV, hd)
        cache = KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
                        t=torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        n = self.n_layers
        if n["mamba"]:
            di = cfg.d_inner
            cache.conv = torch.zeros((n["mamba"], B, cfg.ssm_conv_width - 1,
                                      di), **kw)
            cache.ssm = torch.zeros((n["mamba"], B, di, cfg.ssm_state_dim),
                                    **f32)
        if n["mlstm"]:
            cache.mlstm_C = torch.zeros((n["mlstm"], B, H, hd, hd), **f32)
            cache.mlstm_n = torch.zeros((n["mlstm"], B, H, hd), **f32)
            cache.mlstm_m = torch.full((n["mlstm"], B, H), NEG_INIT, **f32)
        if n["slstm"]:
            shape = (n["slstm"], B, H, hd)
            cache.slstm_c, cache.slstm_n, cache.slstm_h = (
                torch.zeros(shape, **f32) for _ in range(3))
            cache.slstm_m = torch.full(shape, NEG_INIT, **f32)
        if n["xattn"]:
            shape = (n["xattn"], B, cfg.num_image_tokens, KV, hd)
            cache.xk = torch.zeros(shape, **kw)
            cache.xv = torch.zeros(shape, **kw)
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

    # ---------------------------------------------------------------- inputs
    def _embed_in(self, tokens, frames, train: bool = False, sp=None):
        """(B, S, D) inputs of the stack (JAX ``_embed_in``): the token
        embeddings, or with the audio frontend the frame embeddings cast
        to the model's dtype.  With ``sp`` (training over ``model`` with
        the stream split by positions) this rank's block of the S
        positions."""
        cfg = self.cfg
        if cfg.audio_frontend:
            if frames is None:
                raise ValueError(f"{cfg.name} reads frame embeddings "
                                 "(frames=), not tokens")
            return own_block(frames.to(dtype_of(cfg)), sp, 1)
        if tokens is None:
            raise ValueError(f"{cfg.name} reads tokens")
        # F.embedding in training: its gradient is not among the ops
        # PyTorch documents as nondeterministic on the card, so a resumed
        # run repeats a straight one
        if not train:
            return self.embed[tokens]
        if self.embed.shape[0] != cfg.vocab_size:      # rows split: TP
            return vocab_parallel_embedding(tokens, self.embed,
                                            group_for(True),
                                            model_parallel()[2], sp)
        return own_block(Fn.embedding(tokens, self.embed), sp, 1)

    def _image(self, image_embeds):
        """The image embeddings in the model's dtype; a stack with
        cross-attention layers needs them (JAX ``xattn_block``)."""
        if not self.n_layers["xattn"]:
            return None
        if image_embeds is None:
            raise ValueError(f"{self.cfg.name}: cross-attention needs "
                             "image_embeds")
        return image_embeds.to(dtype_of(self.cfg))

    def _rope(self, positions):
        """RoPE tables of ``positions``, or None without attention
        layers."""
        cfg = self.cfg
        if not self.n_attn:
            return None
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    # ------------------------------------------------------------- training
    def _hidden(self, x, remat: bool, image_embeds=None, sp=None):
        """Final-normed hidden states (B, S, D) of the training forward
        from the inputs x (B, S, D), and the summed MoE auxiliary loss:
        every block in train mode at positions 0..S-1, each recomputed in
        the backward pass when ``remat`` (JAX ``run_stack``'s per-block
        checkpoint, which saves each block's input).  With ``sp`` x and
        the result are this rank's block of the positions, and so is
        every block's input and output (``tensor_parallel.seq_parallel``);
        the final norm's weight is read through ``copy_to_model``."""
        S = x.shape[1] * (1 if sp is None else dist.get_world_size(sp))
        rope_cs = self._rope(torch.arange(S, device=self.device))
        img = self._image(image_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            x, a = _remat(blk, x, rope_cs, img, sp) if remat \
                else blk(x, rope_cs, img, sp)
            if a is not None:
                aux = aux + a
        return rmsnorm(x, copy_to_model(self.final_norm, sp),
                       self.cfg.norm_eps), aux

    def _head_weight(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def forward(self, tokens=None, remat: bool = True, *, frames=None,
                image_embeds=None):
        """Training forward (JAX ``LM.forward``): tokens (B, S) int64 (or
        ``frames`` (B, S, D)) on the device, with ``image_embeds``
        (B, T_img, D) for a stack with cross-attention -> float32 logits
        (B, S, V), the head's product taken to float32 without rounding to
        the model's dtype."""
        sp = seq_parallel(*(tokens if frames is None else frames).shape[:2])
        x = self._embed_in(tokens, frames, train=True, sp=sp)
        h, _ = self._hidden(x, remat, image_embeds, sp)
        return matmul_f32(from_stream(h, None, sp), self._head_weight())

    def loss(self, batch, remat: bool = True):
        """Sequence-chunked next-token cross entropy (JAX ``LM.loss``):
        ``batch`` holds "tokens" (or "frames"), "labels" (B, S) int64 on
        the device, labels < 0 masked, and "image_embeds" for a stack
        with cross-attention.  The f32 logits of one ``LOSS_CHUNK`` slice
        of the sequence exist at a time, and each chunk's are recomputed
        in the backward pass.  ``AUX_LOSS_WEIGHT`` times the MoE blocks'
        auxiliary loss is added (0 in a stack without MoE).  With the
        vocabulary split over ``model`` (the train step's tensor
        parallelism) the embedding and the cross entropy are the
        vocab-parallel ones, and every rank computes the same loss.  Where
        the active rules split the stream between blocks by positions
        (``tensor_parallel.seq_parallel``), the stack runs on this rank's
        block of them and the head's input is gathered along the
        sequence."""
        labels = batch["labels"]
        B, S = labels.shape
        sp = seq_parallel(B, S)
        x = self._embed_in(batch.get("tokens"), batch.get("frames"),
                           train=True, sp=sp)
        h, aux = self._hidden(x, remat, batch.get("image_embeds"), sp)
        w = self._head_weight()
        chunk = min(LOSS_CHUNK, S)
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        nll, extra, group = _chunk_nll, (), None
        if w.shape[1] != self.cfg.vocab_size:          # columns split: TP
            group = group_for(True)
            nll, extra = _chunk_nll_vocab_parallel, (group,
                                                     model_parallel()[2])
        h = from_stream(h, group, sp)
        for c0 in range(0, S, chunk):
            tot = tot + _remat(nll, h[:, c0:c0 + chunk], w,
                               labels[:, c0:c0 + chunk], *extra)
        group, world = data_parallel()
        if world > 1:
            # this rank's share of the global batch's mean: the mean over
            # ranks of the ranks' losses is the global loss
            cnt = (labels >= 0).sum().float()
            dist.all_reduce(cnt, group=group)
            return tot * world / cnt.clamp(min=1) + AUX_LOSS_WEIGHT * aux
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
    def prefill(self, tokens=None, pad_to: Optional[int] = None,
                prompt_len=None, cache: Optional[KVCache] = None,
                fill_to: Optional[int] = None, *, frames=None,
                image_embeds=None):
        """Full-prompt forward building the decode cache.

        tokens: (B, S) int64 on the device (or ``frames`` (B, S, D) with
        the audio frontend; ``image_embeds`` (B, T_img, D) for a stack
        with cross-attention, whose projected K/V the cache keeps for
        the decode steps).  Returns (last logits (B, V),
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

        Recurrent layers (Mamba, mLSTM, sLSTM) start from their initial
        states and leave theirs, after the last token given (pads
        included), in the cache: such a stack prefills at exact length
        (the engines' rule).  A stack with any layer but self-attention
        refuses an extend prefill.
        """
        cfg = self.cfg
        x = self._embed_in(tokens, frames)
        B, S = x.shape[:2]
        img = self._image(image_embeds)
        start = 0
        if cache is None:
            cache = self.init_cache(B, max(S, pad_to or 0))
        else:
            if not attention_only(cfg):
                raise ValueError("an extend prefill needs a pure-attention "
                                 f"stack (got pattern {cfg.block_pattern})")
            start = int(cache.t)              # one host read per extend
        rope_cs = self._rope(start + torch.arange(S, device=self.device))
        for blk, g, j in zip(self.blocks, self._group, self._slot):
            if g == "attn":
                x = blk.attn.prefill(x, rope_cs, cache.k[j], cache.v[j],
                                     start=start)
            elif g == "xattn":
                x = blk.xattn.prefill(x, img, cache.xk[j], cache.xv[j])
            else:
                x = self._recurrent(blk, g, j, x, cache, fresh=True)
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
    def decode_step(self, cache: Union[KVCache, PagedKVCache], tokens=None,
                    *, frames=None):
        """One greedy step.  tokens: (B, 1) int64 on the device (or
        ``frames`` (B, 1, D) with the audio frontend).  Writes the step's
        K/V into ``cache`` and advances its fill level(s), both in place
        and on the device (no host synchronisation).  Returns logits
        (B, V).

        Over a ring ``KVCache`` with a shared t the step's K/V land at
        slot t % S; with (B,) levels each lane takes its own RoPE position
        and ring slot.  Over a ``PagedKVCache`` lane b writes physical
        page bt[b, t // page] at in-page slot t % page; a lane past its
        window (a stopped lane stepping to the end of its segment) writes
        the trash page instead, so it can never clobber a page that the
        allocator may hand to another lane (JAX ``attn_block``'s paged
        branch).  Recurrent layers step their states in place;
        cross-attention layers attend the cached image K/V."""
        x = self._embed_in(tokens, frames)
        t = cache.t
        slot = self._decode_slots(cache, x.shape[0]) if self.n_attn else None
        rope_cs = self._rope(t.view(-1, 1) if t.dim() else t.view(1))
        for blk, g, j in zip(self.blocks, self._group, self._slot):
            if g == "xattn":
                x = blk.xattn.decode(x, cache.xk[j], cache.xv[j])
            elif g != "attn":
                x = self._recurrent(blk, g, j, x, cache, fresh=False)
            elif isinstance(cache, PagedKVCache):
                x = blk.attn.decode_paged(x, rope_cs, t, slot, cache.k[j],
                                          cache.v[j], cache.bt)
            else:
                x = blk.attn.decode(x, rope_cs, t, slot, cache.k[j],
                                    cache.v[j])
            x, _ = blk.channel_mix(x)
        t.add_(1)
        return self._head(x)[:, 0]

    @staticmethod
    def _decode_slots(cache, B: int):
        """Where a decode step's K/V land: over a ``PagedKVCache`` each
        lane's flat pool row (B,) int64; over a ring the slot t % S as an
        int64 (1,) tensor for a shared t, or the index pair (lanes,
        slots) for (B,) levels."""
        t = cache.t
        if isinstance(cache, PagedKVCache):
            page, P = cache.page_size, cache.bt.shape[1]
            block = torch.clamp(torch.div(t, page, rounding_mode="floor"),
                                max=P - 1).long()
            pg = cache.bt.gather(1, block[:, None])[:, 0]
            pg = torch.where(t < P * page, pg, torch.zeros_like(pg))
            return (pg * page + torch.remainder(t, page)).long()
        if t.dim():
            return (torch.arange(B, device=t.device),
                    torch.remainder(t, cache.max_len).long())
        return torch.remainder(t, cache.max_len).long().view(1)

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
        on the device.  An attention-cache operation: a stack with any
        layer but self-attention is refused."""
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
    def _recurrent(blk, group, j, x, cache, fresh: bool):
        """Recurrent layer ``j`` of its group's cache (Mamba, mLSTM or
        sLSTM): from the initial states (``fresh``, a prefill) or from
        the cached ones (a decode step); the new states are written into
        the cache in place."""
        names = STATES[group]
        state = None if fresh else tuple(getattr(cache, n)[j]
                                         for n in names)
        if group == "mamba":
            x, new = blk.mamba(x, *(state or ()))
        else:
            x, new = blk.mix(x, state)
        for n, s in zip(names, new):
            getattr(cache, n)[j].copy_(s)
        return x
