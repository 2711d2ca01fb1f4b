"""gemma3-4b-edge [dense] — the paper's own serving backend.

Clairvoyant's end-to-end experiments run Ollama with Gemma3:4b (and
Llama3.1:8b, covered by granite-8b's llama-architecture config).  This config
mirrors Gemma3-4b's published text stack: 34L d_model=2560 8H (GQA kv=4)
head_dim=256 d_ff=10240 vocab=262144.  Used by the serving examples and the
service-time calibration; not part of the assigned 10-arch dry-run matrix.
"""

from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b-edge",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    block_pattern=(ATTN,),
    mlp_activation="gelu",
    rope_theta=1000000.0,
    tie_embeddings=True,
)
