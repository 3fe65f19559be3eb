"""llama4-maverick-400b-a17b [moe]: GQA + 128-expert top-1, interleaved MoE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 with
one shared expert, MoE on every other layer ("interleave_moe_layer_step=2").
Early-fusion multimodality is out of scope for the LM backbone — text
tokens only.  [hf:meta-llama/Llama-4-*; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    family="moe",
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        d_ff_expert=8192,
        n_shared=1,
        router="sigmoid",
        moe_every=2,
        capacity_factor=1.5,         # top-1 needs slack
    ),
    rope_theta=500000.0,
    tie_embeddings=False,
    default_optimizer="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled per assignment)",
)
