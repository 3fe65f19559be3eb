"""stablelm-1.6b [dense]: MHA, LayerNorm.

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    family="dense",
    norm="layernorm",
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
