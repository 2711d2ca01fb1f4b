"""gemma-2b [dense].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000 — GeGLU MLP,
head_dim=256 (attn_dim 2048), multi-query attention.  [arXiv:2403.08295; hf]
"""

from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    block_pattern=(ATTN,),
    mlp_activation="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
