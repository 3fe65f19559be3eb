"""Assigned input-shape cells and meta-device input specs.

Port of ``repro.configs.shapes``.  Every architecture is paired with four
shape cells:

  train_4k     seq 4,096   global_batch 256   → the train step
  prefill_32k  seq 32,768  global_batch 32    → prefill
  decode_32k   seq 32,768  global_batch 128   → one decode token against a
                                                 32k KV cache
  long_500k    seq 524,288 global_batch 1     → decode; only for the
               sub-quadratic archs (hymba, xlstm)

``input_specs`` gives each model input as a tensor on the ``meta`` device
(shape and dtype, no storage), as the reference's ``ShapeDtypeStruct``s;
tokens are int64, the port data pipeline's dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

#: archs with bounded-memory long-context decode (SSM / hybrid families)
SUBQUADRATIC = ("hymba-1.5b", "xlstm-125m")


def cell_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.name in SUBQUADRATIC or cfg.family in ("ssm", "hybrid")
    return True


def input_specs(cfg: ModelConfig, shape: str, *,
                act_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Meta-device stand-ins for every model input of this cell."""
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    spec = lambda shape_, dtype: torch.empty(shape_, dtype=dtype,
                                             device="meta")
    tok = torch.int64
    seq = s if cell.kind != "decode" else 1
    inputs = spec((b, seq), tok) if cfg.frontend == "tokens" \
        else spec((b, seq, cfg.d_model), act_dtype)
    if cell.kind == "train":
        specs = {"inputs": inputs, "targets": spec((b, s), tok),
                 "loss_mask": spec((b, s), torch.float32)}
        if cfg.n_mtp:
            specs["mtp_targets"] = spec((b, s, cfg.n_mtp), tok)
        return specs
    if cell.kind == "prefill":
        return {"inputs": inputs}
    return {"inputs": inputs, "kv_len": spec((b,), torch.int32)}
