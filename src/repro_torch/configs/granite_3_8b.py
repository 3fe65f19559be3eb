"""granite-3-8b [dense]: GQA kv=8, SwiGLU.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-*-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    family="dense",
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
