"""xlstm-125m [ssm]: sLSTM + mLSTM block stack (attention-free).

12L d_model=768 4H d_ff=0 vocab=50304 — xLSTM[7:1]-style: sLSTM blocks at
positions 1 and 9, mLSTM elsewhere; no FFN blocks (d_ff=0).  The FuseMax
attention mapping is inapplicable (no softmax — natively 1-pass; see
``repro.core.taxonomy.mlstm_cascade`` and DESIGN.md §Arch-applicability).
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    family="ssm",
    slstm_layers=(1, 9),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
