"""smollm-360m [dense].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 — llama architecture,
small.  [hf:HuggingFaceTB/SmolLM-135M; hf]
"""

from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp_activation="silu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
