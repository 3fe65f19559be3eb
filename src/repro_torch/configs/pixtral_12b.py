"""pixtral-12b [vlm]: Mistral-Nemo text backbone; ViT frontend stubbed.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
input_specs() provides precomputed patch embeddings [B, S, d_model] (the
Pixtral-ViT frontend is a STUB per the assignment).
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    family="vlm",
    frontend="patches",
    rope_theta=1000000.0,
    tie_embeddings=False,
    source="hf:mistralai/Pixtral-12B-2409",
)
