"""Architecture registry: the 10 assigned configs + reduced smoke variants
(the port's copy of the JAX package's registry) and the input-shape cells
(:mod:`repro_torch.configs.shapes`)."""
from __future__ import annotations

from repro_torch.configs.base import (
    LayerSpec, MLAConfig, ModelConfig, MoEConfig, SSMConfig, reduced,
)
from repro_torch.configs.shapes import (
    SHAPES, SUBQUADRATIC, ShapeCell, cell_applicable, input_specs,
)

from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.granite_3_8b import CONFIG as GRANITE_3_8B
from repro_torch.configs.stablelm_1_6b import CONFIG as STABLELM_1_6B
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM_125M

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        MUSICGEN_LARGE,
        DEEPSEEK_V3_671B,
        LLAMA4_MAVERICK,
        GEMMA2_9B,
        GEMMA_7B,
        GRANITE_3_8B,
        STABLELM_1_6B,
        PIXTRAL_12B,
        HYMBA_1_5B,
        XLSTM_125M,
    )
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]


__all__ = [
    "ARCHS", "LayerSpec", "MLAConfig", "ModelConfig", "MoEConfig",
    "SHAPES", "SSMConfig", "SUBQUADRATIC", "ShapeCell", "cell_applicable",
    "get_config", "input_specs", "reduced",
]
