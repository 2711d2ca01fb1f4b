"""jamba-v0.1-52b [hybrid].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Mamba + attention at a 1:7 ratio (one attention layer per 8), MoE on every
other layer.  Sub-quadratic overall: Mamba layers decode from O(1) state; the
four attention layers hold the (sharded) KV cache.  Runs long_500k.
[arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ATTN, MAMBA, MAMBA_MOE, ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    # 8-layer period: 7 mamba (4 of them MoE) + 1 attention.  MoE every other
    # layer as in Jamba v0.1.
    block_pattern=(MAMBA, MAMBA_MOE, MAMBA, MAMBA_MOE, ATTN, MAMBA_MOE, MAMBA, MAMBA_MOE),
    num_experts=16,
    experts_per_token=2,
    mlp_activation="silu",
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
)
