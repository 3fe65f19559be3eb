"""deepseek-v3-671b [moe]: MLA + 256-expert top-8 MoE + MTP.

61L d_model=7168 128H (MLA) d_ff=2048(expert) vocab=129280, 1 shared + 256
routed top-8, first 3 layers dense, multi-token prediction head.
[arXiv:2412.19437; hf]

Notes: the assigned line gives d_ff=2048 — the *expert* width; the three
dense-prefix layers use the model's dense FFN width 18432 (model card).
Sigmoid router with top-8 renormalization (aux-loss-free balancing's bias
update is not modeled; see DESIGN.md).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                      # dense-prefix layers
    vocab=129280,
    family="moe",
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        router="sigmoid",
        first_k_dense=3,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_dim=64,
        nope_dim=128,
        v_dim=128,
    ),
    n_mtp=1,
    tie_embeddings=False,
    default_optimizer="adafactor",   # fp32 AdamW states for 671B do not fit
    source="arXiv:2412.19437",
)
