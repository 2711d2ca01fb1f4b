"""Block dispatch over the block pattern (port of
``repro.models.transformer``'s ``init_block`` / ``apply_block``).

A block is a sequence mixer (GQA attention or the Mamba SSM) followed by
a channel mixer (the gated MLP or the MoE MLP), each pre-normed with its
residual:

* ``attn``: attention + MLP;      ``attn_moe``: attention + MoE;
* ``mamba``: Mamba + MLP;         ``mamba_moe``: Mamba + MoE.

The JAX package scans the stack over pattern repeats; the port's ``LM``
loops over its layers, layer ``i`` being pattern position
``i % len(pattern)`` of repeat ``i // len(pattern)``.  The xLSTM blocks
(``slstm``, ``mlstm``), cross-attention (``xattn``) and the audio
frontend are not ported yet: building a config that needs one raises
``NotImplementedError`` naming it (a refusal, not a substitute).
"""

from __future__ import annotations

from torch import nn

from repro_torch.configs.base import (ATTN, ATTN_MOE, MAMBA, MAMBA_MOE,
                                      MLSTM, SLSTM, XATTN)
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba

ATTN_KINDS = (ATTN, ATTN_MOE)
MAMBA_KINDS = (MAMBA, MAMBA_MOE)
MOE_KINDS = (ATTN_MOE, MAMBA_MOE)

#: what each unported kind still needs (the next slice of the port)
_UNPORTED = {
    SLSTM: "the sLSTM block (models/xlstm.py)",
    MLSTM: "the mLSTM block (models/xlstm.py)",
    XATTN: "the cross-attention block (xattn_block)",
}


def check_buildable(cfg) -> None:
    """Raise ``NotImplementedError`` naming what ``cfg`` needs that the
    port does not build yet."""
    for kind in cfg.block_pattern:
        if kind in _UNPORTED:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} needs {_UNPORTED[kind]}, "
                "which is not ported yet")
        if kind not in ATTN_KINDS + MAMBA_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg.audio_frontend:
        raise NotImplementedError(
            f"{cfg.name}: the audio frontend (models/frontends.py) is not "
            "ported yet")


def attention_only(cfg) -> bool:
    """Every block mixes its sequence by attention (the stacks a paged
    pool and the verify forward can hold)."""
    return all(k in ATTN_KINDS for k in cfg.block_pattern)


def attention_layers(cfg) -> int:
    """The stack's attention layers: those holding K/V, each launching
    the attention kernels once a prefill or a decode step."""
    return sum(k in ATTN_KINDS for k in cfg.block_pattern) \
        * cfg.pattern_repeats


class Block(nn.Module):
    """One block of kind ``kind``.  Parameters sit under ``attn`` or
    ``mamba`` and under ``mlp`` or ``moe``, the JAX leaves' names."""

    def __init__(self, cfg, kind: str, gen, device):
        super().__init__()
        self.kind = kind
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, gen, device)
        else:
            self.mamba = Mamba(cfg, gen, device)
        if kind in MOE_KINDS:
            self.moe = MoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg, gen, device)

    @property
    def is_attn(self) -> bool:
        return self.kind in ATTN_KINDS

    def channel_mix(self, x):
        """(x after the MLP or MoE, the MoE's auxiliary loss or None)."""
        if self.kind in MOE_KINDS:
            return self.moe(x)
        return self.mlp(x), None

    def forward(self, x, rope_cs):
        """Training (mode ``"train"``): x (B, S, D) at positions 0..S-1
        -> (x, aux or None)."""
        if self.is_attn:
            x = self.attn(x, rope_cs)
        else:
            x, _ = self.mamba(x)
        return self.channel_mix(x)
