"""Architecture configuration for the PyTorch port.

A copy of the fields of ``repro.configs.base.ArchConfig`` that an
attention-only stack reads, the ``reduced()`` rule the tests use, and two
architectures:

* ``smollm-360m`` (HuggingFaceTB/SmolLM-360M ``config.json``: 32 layers,
  d_model 960, 15 query heads over 5 KV heads of width 64, SwiGLU d_ff
  2560, vocab 49152, tied embeddings, RoPE theta 1e4), the engines' and
  the sidecar's default;
* ``gemma3-4b-edge`` (Gemma3-4b's text stack, the paper's own backend: 34
  layers, d_model 2560, 8 query heads over 4 KV heads of width 256, GeGLU
  d_ff 10240, vocab 262144, tied embeddings, RoPE theta 1e6), served by
  the same engines and priced by the launch CLIs' service-time model
  (``ServiceTimeModel.from_arch``).  As in the reference, it has no
  embedding scale, no QK-norm, no softcap and no sliding window.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """A pre-norm attention + gated-MLP (SwiGLU or GeGLU) decoder stack
    (the only block kind ported)."""
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
    mlp_activation: str = "silu"   # silu (SwiGLU) | gelu (GeGLU)

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

    def active_param_count(self) -> int:
        """Parameters a token touches: all of them in a dense stack."""
        return self.param_count()

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

GEMMA3_4B_EDGE = ArchConfig(
    name="gemma3-4b-edge", num_layers=34, d_model=2560, num_heads=8,
    num_kv_heads=4, head_dim=256, d_ff=10240, vocab_size=262144,
    mlp_activation="gelu", rope_theta=1000000.0, tie_embeddings=True)

_CONFIGS = {c.name: c for c in (SMOLLM_360M, GEMMA3_4B_EDGE)}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_CONFIGS)}")
    return _CONFIGS[name]
