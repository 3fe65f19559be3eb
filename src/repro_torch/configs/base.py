"""Model configuration schema + the per-layer spec pattern machinery.

``ModelConfig`` covers every assigned architecture family: dense GQA
transformers, MoE (top-k, shared experts, dense-prefix, interleaved),
MLA (DeepSeek latent attention), local/global alternation + softcaps
(Gemma-2), parallel attention+SSM hybrids (Hymba), and recurrent
sLSTM/mLSTM stacks (xLSTM).  ``layer_specs()`` expands the config into an
explicit per-layer list; ``runs()`` groups equal consecutive specs into
*runs*, the unit the JAX package stacks its parameters by — the weight
bridge (:mod:`repro_torch.bridge`) reads that grouping to unstack them into
the port's per-layer modules.

A copy of the JAX package's ``configs/base.py``, kept field for field
equal (tests/test_torch_model.py checks every architecture).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                 # shared (always-on) experts
    capacity_factor: float = 1.25
    router: str = "softmax"           # "softmax" | "sigmoid" (DeepSeek-V3)
    #: layers 0..first_k_dense-1 use a dense FFN instead (DeepSeek-V3: 3)
    first_k_dense: int = 0
    #: MoE every Nth layer (Llama-4: 2 → alternate dense/MoE); 1 = all MoE
    moe_every: int = 1
    aux_loss_weight: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2/V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_dim: int = 64                # decoupled-RoPE dims (shared key)
    nope_dim: int = 128               # non-rotary per-head q/k dims
    v_dim: int = 128                  # per-head value dims


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model / 16)


@dataclass(frozen=True)
class LayerSpec:
    """Structure of one layer; equal specs are scanned together."""
    attn: str = "gqa"                 # "gqa" | "mla" | "none"
    window: Optional[int] = None      # sliding window (None = global)
    mlp: str = "dense"                # "dense" | "moe" | "none"
    ssm: Optional[str] = None         # "mamba" | "mlstm" | "slstm" | None
    parallel_ssm: bool = False        # hymba: attn ∥ ssm on the same input


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    family: str = "dense"             # dense | moe | hybrid | ssm | audio | vlm
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    causal: bool = True
    window: Optional[int] = None                 # uniform sliding window
    local_global_every: int = 0                  # gemma2: 2 → alternate
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mlp_act: str = "silu"
    norm: str = "rmsnorm"
    post_norm: bool = False                      # gemma2 sandwich norms
    tie_embeddings: bool = True
    embed_scale: bool = False                    # gemma: x *= sqrt(d)
    frontend: str = "tokens"                     # tokens | frames | patches
    n_mtp: int = 0                               # DeepSeek MTP heads
    # hybrid/ssm structure
    hybrid_global_layers: Tuple[int, ...] = ()   # hymba full-attn layers
    slstm_layers: Tuple[int, ...] = ()           # xlstm sLSTM positions
    #: which optimizer the launcher defaults to (Adafactor for 400B+)
    default_optimizer: str = "adamw"
    #: citation string for provenance
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        specs = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kind = "slstm" if i in self.slstm_layers else "mlstm"
                specs.append(LayerSpec(attn="none", mlp="none", ssm=kind))
                continue
            # attention flavor
            attn = "mla" if self.mla is not None else "gqa"
            window = self.window
            if self.local_global_every:
                # even layers local, odd layers global (gemma-2 ordering)
                window = self.window if i % self.local_global_every == 0 \
                    else None
            if self.family == "hybrid":
                window = None if i in self.hybrid_global_layers else self.window
            # mlp flavor
            mlp_kind = "dense"
            if self.moe is not None:
                in_dense_prefix = i < self.moe.first_k_dense
                on_moe_stride = (i % self.moe.moe_every) == self.moe.moe_every - 1
                if not in_dense_prefix and on_moe_stride:
                    mlp_kind = "moe"
            specs.append(
                LayerSpec(
                    attn=attn,
                    window=window,
                    mlp=mlp_kind,
                    ssm="mamba" if self.family == "hybrid" else None,
                    parallel_ssm=self.family == "hybrid",
                )
            )
        return tuple(specs)

    def runs(self) -> Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]:
        """Group the layer stack into (pattern, repeats) runs.

        A run is a repeating *pattern* of up to 4 layer specs — this keeps
        alternating stacks scannable (gemma-2's (local, global)×21,
        llama-4's (dense, moe)×24) instead of degenerating into per-layer
        unrolls.  Patterns with a single repeat collapse to period 1.
        """
        specs = list(self.layer_specs())
        out = []
        i, n = 0, len(specs)
        while i < n:
            best_p, best_r = 1, 1
            # count repeats of the period-1 block too
            for p in (1, 2, 3, 4):
                block = specs[i : i + p]
                if len(block) < p:
                    break
                r = 1
                while specs[i + r * p : i + (r + 1) * p] == block:
                    r += 1
                if p > 1 and r < 2:
                    continue          # non-repeating pattern is not a run
                if p * r > best_p * best_r:
                    best_p, best_r = p, r
            out.append((tuple(specs[i : i + best_p]), best_r))
            i += best_p * best_r
        return tuple(out)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, dh = self.d_model, self.dh
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        for spec in self.layer_specs():
            if spec.attn == "gqa":
                n += d * self.n_heads * dh            # Wq
                n += 2 * d * self.n_kv_heads * dh     # Wk, Wv
                n += self.n_heads * dh * d            # Wo
            elif spec.attn == "mla":
                m = self.mla
                qk_dim = m.nope_dim + m.rope_dim
                n += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
                n += d * (m.kv_lora_rank + m.rope_dim)
                n += m.kv_lora_rank * self.n_heads * (m.nope_dim + m.v_dim)
                n += self.n_heads * m.v_dim * d
            if spec.ssm is not None and self.ssm is not None:
                di = self.ssm.expand * d
                if spec.ssm == "mamba":
                    dt_rank = self.ssm.dt_rank or -(-d // 16)
                    n += d * 2 * di + di * self.ssm.conv_dim
                    n += di * (dt_rank + 2 * self.ssm.state_dim)
                    n += dt_rank * di + di * self.ssm.state_dim + di
                    n += di * d
                else:                                  # mlstm / slstm
                    n += d * 3 * di + 3 * di + di * d + d * di
            if spec.mlp == "dense":
                n += 3 * d * self.d_ff
            elif spec.mlp == "moe":
                mo = self.moe
                n += d * mo.n_experts                  # router
                n += mo.n_experts * 3 * d * mo.d_ff_expert
                n += mo.n_shared * 3 * d * mo.d_ff_expert
        return n


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving its structure."""
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // cfg.n_heads, 4)),
        d_ff=256,
        vocab=512,
        head_dim=32,
    )
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=128,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.mla is not None:
        base["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, rope_dim=16, nope_dim=32,
            v_dim=32)
        base["head_dim"] = None
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8)
    if cfg.window is not None:
        base["window"] = 64
    if cfg.hybrid_global_layers:
        base["hybrid_global_layers"] = (0, base["n_layers"] - 1)
    if cfg.slstm_layers:
        base["slstm_layers"] = (1,)
    base["name"] = cfg.name + "-smoke"
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
