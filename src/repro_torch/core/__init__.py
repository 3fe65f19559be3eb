"""FuseMax core: the paper's contribution as composable modules.

Port of ``repro.core``.  Symbolic layer: Einsum cascade IR +
mapping-independent pass analysis (pure Python, copies of the
reference's).  Numeric layer: the 3/2/1-pass attention cascades (+ decode
split-K) in torch.
"""
from repro_torch.core.einsum import Cascade, Einsum, RankUse, T, TensorRef
from repro_torch.core.passes import (
    PassAnalysis,
    analyze,
    classify_passes,
    count_passes,
    min_live_footprint,
)
from repro_torch.core.taxonomy import (
    all_attention_cascades,
    attention_1pass as attention_1pass_cascade,
    attention_2pass as attention_2pass_cascade,
    attention_3pass as attention_3pass_cascade,
    cascade1_two_pass_example,
    cascade2_deferred_multiply,
    cascade3_iterative,
    mlstm_cascade,
    table1,
)
from repro_torch.core.cascades_numeric import (
    AttnSpec,
    attention_1pass,
    attention_2pass,
    attention_3pass,
    attention_decode_1pass,
    division_counts,
    reference_attention,
)

__all__ = [
    "AttnSpec",
    "Cascade",
    "Einsum",
    "PassAnalysis",
    "RankUse",
    "T",
    "TensorRef",
    "all_attention_cascades",
    "analyze",
    "attention_1pass",
    "attention_1pass_cascade",
    "attention_2pass",
    "attention_2pass_cascade",
    "attention_3pass",
    "attention_3pass_cascade",
    "attention_decode_1pass",
    "cascade1_two_pass_example",
    "cascade2_deferred_multiply",
    "cascade3_iterative",
    "classify_passes",
    "count_passes",
    "division_counts",
    "min_live_footprint",
    "mlstm_cascade",
    "reference_attention",
    "table1",
]
