"""Gradient compression with error feedback.

Port of ``repro.optim.compression``: both schemes carry a residual, so
the compression bias vanishes over steps (Karimireddy et al., 2019).

  ``ef_int8_compress``  per-tensor-scaled int8 quantization,
  ``ef_topk_compress``  magnitude top-k sparsification (``torch.topk``;
                        on tied magnitudes its pick may differ from
                        ``jax.lax.top_k``'s, the threshold does not).

Each per-tensor statistic (the int8 scale, the top-k threshold and its
k) spans one of ``groups`` (the layers of a run, which the reference
stacks in one leaf) or one other leaf alone.
"""
from __future__ import annotations

import torch

from repro_torch.optim.common import (
    partition_leaves, tree_flatten, tree_map, tree_unflatten,
)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _by_group(compress, grads, residual, groups):
    """``compress(grads, residuals)`` (lists of one group's leaves, the
    residual added) over each group → (decompressed grads, residual)."""
    g, r = tree_flatten(grads), tree_flatten(residual)
    out_g, out_r = {}, {}
    for group in partition_leaves(g, groups):
        gfs = [g[k].float() + r[k] for k in group]
        for k, gf, kept in zip(group, gfs, compress(gfs)):
            out_g[k] = kept.to(g[k].dtype)
            out_r[k] = gf - kept
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_r)


def ef_int8_compress(grads, residual, groups=None):
    """Returns (decompressed grads, new residual)."""
    def one(gfs):
        amax = torch.stack([torch.max(torch.abs(gf)) for gf in gfs]).max()
        scale = amax / 127.0 + 1e-12
        return [torch.clamp(torch.round(gf / scale), -127, 127)
                .to(torch.int8).float() * scale for gf in gfs]

    return _by_group(one, grads, residual, groups)


def ef_topk_compress(grads, residual, frac: float = 0.1, groups=None):
    """Keep the top ``frac`` fraction of entries by magnitude; entries tied
    with the threshold are all kept."""
    def one(gfs):
        flat = torch.cat([gf.reshape(-1) for gf in gfs])
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        return [gf * (torch.abs(gf) >= thresh).float() for gf in gfs]

    return _by_group(one, grads, residual, groups)
