"""Block dispatch over the block pattern (port of
``repro.models.transformer``'s ``init_block`` / ``apply_block``).

A block is a sequence mixer followed by a channel mixer, each pre-normed
with its residual:

* ``attn``: GQA attention + MLP;      ``attn_moe``: attention + MoE;
* ``mamba``: Mamba + MLP;             ``mamba_moe``: Mamba + MoE;
* ``xattn``: cross-attention over the image embeddings + MLP;
* ``slstm``, ``mlstm``: the xLSTM blocks (``models.xlstm``), each with
  its own ungated up/down projection in place of the MLP.

The JAX package scans the stack over pattern repeats; the port's ``LM``
loops over its layers, layer ``i`` being pattern position
``i % len(pattern)`` of repeat ``i // len(pattern)``.  Every kind the
registry uses is built, and the audio frontend is the ``LM``'s own
(frame embeddings in place of the token embedding).
"""

from __future__ import annotations

from torch import nn

from repro_torch.configs.base import (ATTN, ATTN_MOE, MAMBA, MAMBA_MOE,
                                      MLSTM, SLSTM, XATTN)
from repro_torch.models.attention import Attention, CrossAttention
from repro_torch.models.layers import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba
from repro_torch.models.xlstm import MLSTMBlock, SLSTMBlock

ATTN_KINDS = (ATTN, ATTN_MOE)
MAMBA_KINDS = (MAMBA, MAMBA_MOE)
MOE_KINDS = (ATTN_MOE, MAMBA_MOE)


def cache_group(kind: str) -> str:
    """The cache a layer of ``kind`` holds its state in: "attn" (ring
    K/V), "mamba", "xattn" (image K/V), "mlstm" or "slstm"."""
    if kind in ATTN_KINDS:
        return "attn"
    if kind in MAMBA_KINDS:
        return "mamba"
    if kind in (XATTN, MLSTM, SLSTM):
        return kind
    raise ValueError(f"unknown block kind {kind!r}")


def attention_only(cfg) -> bool:
    """Every block mixes its sequence by self-attention (the stacks a
    paged pool, an extend prefill and the verify forward can hold)."""
    return all(k in ATTN_KINDS for k in cfg.block_pattern)


def attention_layers(cfg) -> int:
    """The stack's self-attention layers: those holding ring K/V, each
    launching the attention kernels once a prefill or a decode step
    (layer i of kind ``block_pattern[i % len]``, as ``LM`` builds them:
    a stack cut short of a whole pattern counts its own layers)."""
    pattern = cfg.block_pattern
    return sum(pattern[i % len(pattern)] in ATTN_KINDS
               for i in range(cfg.num_layers))


def flash_layers(cfg) -> int:
    """The stack's layers that attend in training: the self-attention
    layers (causal) and the cross-attention layers (non-causal over the
    image rows), each launching K3 twice a train step (its forward and
    remat's recomputation) and K3b once."""
    pattern = cfg.block_pattern
    return attention_layers(cfg) + sum(
        pattern[i % len(pattern)] == XATTN for i in range(cfg.num_layers))


class Block(nn.Module):
    """One block of an attention, Mamba or cross-attention kind.
    Parameters sit under ``attn``, ``mamba`` or ``xattn`` and under
    ``mlp`` or ``moe``, the JAX leaves' names."""

    def __init__(self, cfg, kind: str, gen, device):
        super().__init__()
        self.kind = kind
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, gen, device)
        elif kind == XATTN:
            self.xattn = CrossAttention(cfg, gen, device)
        else:
            self.mamba = Mamba(cfg, gen, device)
        if kind in MOE_KINDS:
            self.moe = MoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg, gen, device)

    @property
    def is_attn(self) -> bool:
        return self.kind in ATTN_KINDS

    def channel_mix(self, x, sp=None):
        """(x after the MLP or MoE, the MoE's auxiliary loss or None)."""
        if self.kind in MOE_KINDS:
            return self.moe(x, sp)
        return self.mlp(x, sp), None

    def forward(self, x, rope_cs, image_embeds=None, sp=None):
        """Training (mode ``"train"``): x (B, S, D) at positions 0..S-1
        -> (x, aux or None); with ``sp`` (the stream split by positions
        over ``model``, ``tensor_parallel.seq_parallel``) x is this rank's
        block of them and so is the result."""
        if self.is_attn:
            x = self.attn(x, rope_cs, sp)
        elif self.kind == XATTN:
            x = self.xattn(x, image_embeds, sp)
        else:
            x, _ = self.mamba(x, sp=sp)
        return self.channel_mix(x, sp)


def make_block(cfg, kind: str, gen, device) -> nn.Module:
    """The block of ``kind`` (``init_block``): an xLSTM block module, or
    a :class:`Block`."""
    cache_group(kind)                       # raises on an unknown kind
    if kind == MLSTM:
        return MLSTMBlock(cfg, gen, device)
    if kind == SLSTM:
        return SLSTMBlock(cfg, gen, device)
    return Block(cfg, kind, gen, device)
