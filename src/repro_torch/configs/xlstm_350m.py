"""xlstm-350m [ssm].

24L d_model=1024 4H d_ff=0 vocab=50304 — alternating sLSTM + mLSTM blocks
(xLSTM, arXiv:2405.04517).  No separate FFN (d_ff=0): each xLSTM block carries
its own up/down projection.  Sub-quadratic: state-based decode, runs long_500k.
[arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import MLSTM, SLSTM, ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(SLSTM, MLSTM),
    tie_embeddings=True,
)
