"""llama-3.2-vision-90b [vlm].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 — cross-attention
image layers every 5th layer (20 of 100).  The vision encoder is a STUB:
``input_specs()`` supplies precomputed patch embeddings of shape
(batch, num_image_tokens, d_model).  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]
"""

from repro_torch.configs.base import ATTN, XATTN, ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=(ATTN, ATTN, ATTN, ATTN, XATTN),
    mlp_activation="silu",
    rope_theta=500000.0,
    num_image_tokens=1024,
)
