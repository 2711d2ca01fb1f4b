"""Architecture configuration for the PyTorch port.

A copy of the fields of ``repro.configs.base.ArchConfig`` that an
attention-only stack reads, the ``reduced()`` rule the tests use, and the
one architecture this slice serves: ``smollm-360m`` (HuggingFaceTB/SmolLM-360M
``config.json``: 32 layers, d_model 960, 15 query heads over 5 KV heads of
width 64, SwiGLU d_ff 2560, vocab 49152, tied embeddings, RoPE theta 1e4).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """A pre-norm attention + SwiGLU decoder stack (the only block kind
    ported)."""
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = (d * self.attn_dim + 2 * d * self.kv_dim
                     + self.attn_dim * d + d + 3 * d * ff + d)
        head = 0 if self.tie_embeddings else v * d
        return v * d + head + d + self.num_layers * per_layer

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (same rule as the JAX
        package's ``ArchConfig.reduced``)."""
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % num_kv:
            num_kv -= 1
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=1, d_model=64,
            num_heads=num_heads, num_kv_heads=num_kv, head_dim=16,
            d_ff=128 if self.d_ff else 0, vocab_size=512, dtype="float32")


SMOLLM_360M = ArchConfig(
    name="smollm-360m", num_layers=32, d_model=960, num_heads=15,
    num_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=49152,
    rope_theta=10000.0, tie_embeddings=True)

_CONFIGS = {SMOLLM_360M.name: SMOLLM_360M}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_CONFIGS)}")
    return _CONFIGS[name]
