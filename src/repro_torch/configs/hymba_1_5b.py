"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (1024) everywhere except three full-attention
layers (first / middle / last, per the paper); each layer fuses the
attention and SSM branch outputs (mean).  Meta-tokens are not modeled
(DESIGN.md §Arch-applicability).  [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    family="hybrid",
    window=1024,
    hybrid_global_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    tie_embeddings=True,
    source="arXiv:2411.13676",
)
