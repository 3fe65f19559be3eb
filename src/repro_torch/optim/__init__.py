"""Optimizers (torch; state as trees keyed like the parameters).  Port of
``repro.optim``."""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.common import (
    Optimizer, clip_by_global_norm, global_norm, tree_leaves, tree_map,
)
from repro_torch.optim.compression import (
    ef_int8_compress, ef_topk_compress, init_error_feedback,
)
from repro_torch.optim.schedule import warmup_cosine


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer: {name}")


__all__ = [
    "Optimizer", "adafactor", "adamw", "clip_by_global_norm",
    "ef_int8_compress", "ef_topk_compress", "global_norm",
    "init_error_feedback", "make_optimizer", "tree_leaves", "tree_map",
    "warmup_cosine",
]
