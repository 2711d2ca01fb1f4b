"""Architecture and shape configuration (a copy of
``repro.configs.base``; the port imports nothing of the JAX package).

Every architecture is described by an :class:`ArchConfig`, a frozen
dataclass.  Layer stacks are expressed as a *block pattern*: the smallest
repeating unit of heterogeneous blocks (e.g. Jamba's ``7 x mamba + 1 x
attn``).  The full model is ``pattern x repeats``; the JAX package scans
over repeats, the port's ``LM`` loops over its layers, layer ``i`` being
pattern position ``i % len(pattern)`` of repeat ``i // len(pattern)``.
Below the imports the code is the JAX package's, line for line.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Block kinds understood by models/transformer.py
ATTN = "attn"            # self-attention + dense MLP
ATTN_MOE = "attn_moe"    # self-attention + MoE MLP
XATTN = "xattn"          # cross-attention (VLM) + dense MLP
MAMBA = "mamba"          # selective-SSM block + dense MLP
MAMBA_MOE = "mamba_moe"  # selective-SSM block + MoE MLP
SLSTM = "slstm"          # xLSTM scalar-memory block
MLSTM = "mlstm"          # xLSTM matrix-memory block

BLOCK_KINDS = (ATTN, ATTN_MOE, XATTN, MAMBA, MAMBA_MOE, SLSTM, MLSTM)

SUBQUADRATIC_KINDS = (MAMBA, MAMBA_MOE, SLSTM, MLSTM)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

SHAPE_NAMES = tuple(SHAPES)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Repeating block pattern; len(block_pattern) must divide num_layers.
    block_pattern: Tuple[str, ...] = (ATTN,)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # MLP / attention details
    mlp_activation: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 500000.0
    logit_softcap: float = 0.0

    # SSM (mamba) details
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2

    # VLM
    num_image_tokens: int = 0    # length of precomputed patch-embedding sequence
    # Audio
    audio_frontend: bool = False  # inputs are precomputed frame embeddings

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # Shape applicability -------------------------------------------------
    # Pure full-attention archs skip long_500k (needs sub-quadratic attention).
    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.subquadratic
        return True

    @property
    def subquadratic(self) -> bool:
        """True if the sequence-mixing stack is sub-quadratic (SSM / hybrid).

        A hybrid with a small attention fraction still decodes a 500k context in
        O(seq) bandwidth per token (linear, not quadratic), so hybrids qualify.
        """
        return any(k in SUBQUADRATIC_KINDS for k in self.block_pattern)

    @property
    def pattern_repeats(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        return self.num_layers // len(self.block_pattern)

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    # Parameter accounting -------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the model as constructed by models/model.py."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = 0
        if not self.audio_frontend:
            total += v * d  # input embedding (audio uses the frame stub)
        if not self.tie_embeddings:
            total += v * d  # lm head
        total += d  # final norm
        for kind in self.block_pattern:
            total += self._block_params(kind) * self.pattern_repeats
        return total

    def _block_params(self, kind: str) -> int:
        d, ff = self.d_model, self.d_ff
        attn = (
            d * self.attn_dim          # Wq
            + 2 * d * self.kv_dim      # Wk, Wv
            + self.attn_dim * d        # Wo
            + d                        # pre-norm
            + (2 * self.head_dim if self.qk_norm else 0)
        )
        mlp = 3 * d * ff + d if ff else 0  # gate, up, down + pre-norm
        moe = 0
        if kind in (ATTN_MOE, MAMBA_MOE):
            moe = self.num_experts * 3 * d * ff + d * self.num_experts + d
            mlp = 0
        mamba = 0
        if kind in (MAMBA, MAMBA_MOE):
            attn = 0  # mamba blocks replace attention entirely
            di, n = self.d_inner, self.ssm_state_dim
            mamba = (
                2 * d * di            # in_proj (x and z branches)
                + di * self.ssm_conv_width
                + di * (n * 2 + 1)    # B, C, dt projections (x -> B,C,dt)
                + di * n              # A_log
                + di                  # D skip
                + di                  # dt bias
                + di * d              # out_proj
                + d                   # pre-norm
            )
        if kind == MLSTM:
            ad = self.attn_dim
            attn = (
                3 * d * ad                # q, k, v projections
                + 2 * d * self.num_heads  # i, f gate projections (per head)
                + ad * d                  # out proj
                + 2 * d                   # pre-norm + norm2
                + 2 * d * d               # up/down proj block
            )
            mlp = 0
        if kind == SLSTM:
            ad, hd = self.attn_dim, self.head_dim
            attn = (
                4 * d * ad                       # z,i,f,o input projections
                + 4 * self.num_heads * hd * hd   # block-diagonal recurrent
                + 4 * ad                         # gate biases
                + ad * d                         # out proj
                + 2 * d                          # pre-norm + norm2
                + 2 * d * d                      # up/down proj block
            )
            mlp = 0
        return attn + mlp + moe + mamba

    def active_param_count(self) -> int:
        """Active parameters per token (MoE archs activate experts_per_token)."""
        if not self.num_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        per_moe_block_inactive = (self.num_experts - self.experts_per_token) * 3 * d * ff
        n_moe_blocks = sum(
            1 for k in self.block_pattern if k in (ATTN_MOE, MAMBA_MOE)
        ) * self.pattern_repeats
        return self.param_count() - n_moe_blocks * per_moe_block_inactive

    # Reduced config for CPU smoke tests ------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config: identical block pattern, small dims."""
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # preserve MQA/GQA structure
        while num_heads % num_kv:
            num_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=len(self.block_pattern),
            d_model=64,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_image_tokens=16 if self.num_image_tokens else 0,
            ssm_state_dim=4,
            dtype="float32",
        )
