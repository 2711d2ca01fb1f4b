"""llama4-maverick-400b-a17b [moe].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.
Llama-4 interleaves dense and MoE FFN layers (interleave step 2), which is also
what makes the totals work out: 24 MoE layers x 128 x 3*5120*8192 ~= 386B plus
dense/attention/embedding ~= 400B total, ~17B active.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.configs.base import ATTN, ATTN_MOE, ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=(ATTN, ATTN_MOE),
    num_experts=128,
    experts_per_token=1,
    mlp_activation="silu",
    rope_theta=500000.0,
)
