"""musicgen-large [audio].

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048 — decoder-only
transformer over EnCodec tokens.  The EnCodec frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings (batch, seq, d_model);
the LM head predicts the 2048-way codebook.  [arXiv:2306.05284; hf]
"""

from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(ATTN,),
    mlp_activation="gelu",
    rope_theta=10000.0,
    audio_frontend=True,
)
