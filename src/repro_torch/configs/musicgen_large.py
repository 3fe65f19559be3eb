"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048  [arXiv:2306.05284; hf]
The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, S, d_model]; the LM head predicts codebook tokens (vocab
2048).  Full MHA (kv = heads), sinusoidal positions approximated by RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    family="audio",
    frontend="frames",
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=False,
    causal=True,
    source="arXiv:2306.05284",
)
