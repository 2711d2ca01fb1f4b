"""qwen3-32b [dense].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936 — qk_norm, GQA,
head_dim=128 (attn_dim 8192 != d_model).  [hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    block_pattern=(ATTN,),
    mlp_activation="silu",
    qk_norm=True,
    rope_theta=1000000.0,
)
