"""gemma-7b [dense]: GeGLU, head_dim=256.

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    family="dense",
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
