"""granite-8b [dense].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 — llama architecture,
code-tuned.  [arXiv:2405.04324; hf]
"""

from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp_activation="silu",
    rope_theta=10000.0,
)
