"""dbrx-132b [moe].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16 experts top-4
(fine-grained) on every layer.  [hf:databricks/dbrx-base; unverified]
"""

from repro_torch.configs.base import ATTN_MOE, ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    block_pattern=(ATTN_MOE,),
    num_experts=16,
    experts_per_token=4,
    mlp_activation="silu",
    rope_theta=500000.0,
)
