"""gemma2-9b [dense]: local/global alternation, logit softcaps, GeGLU.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
sliding window 4096 on even layers, attn softcap 50, final softcap 30,
sandwich (post) norms, embeddings scaled by sqrt(d).  [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    family="dense",
    window=4096,
    local_global_every=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
