"""Gradient compression with error feedback.

Port of ``repro.optim.compression``: both schemes carry a residual, so
the compression bias vanishes over steps (Karimireddy et al., 2019).

  ``ef_int8_compress``  per-tensor-scaled int8 quantization,
  ``ef_topk_compress``  magnitude top-k sparsification (``torch.topk``;
                        on tied magnitudes its pick may differ from
                        ``jax.lax.top_k``'s, the threshold does not).

As in :mod:`repro_torch.optim.adafactor`, the port's per-tensor
statistics (the int8 scale, the top-k threshold) are per layer, where the
reference's stacked leaves take one over a run's layers.
"""
from __future__ import annotations

import torch

from repro_torch.optim.common import tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _pick(tree, i: int):
    """The i-th element of every (grad, residual) pair of a tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def ef_int8_compress(grads, residual):
    """Returns (decompressed grads, new residual)."""
    def one(g, r):
        gf = g.float() + r
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, residual)
    return _pick(out, 0), _pick(out, 1)


def ef_topk_compress(grads, residual, frac: float = 0.1):
    """Keep the top ``frac`` fraction of entries by magnitude."""
    def one(g, r):
        gf = g.float() + r
        flat = gf.reshape(-1)
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        kept = gf * (torch.abs(gf) >= thresh).float()
        return kept.to(g.dtype), gf - kept

    out = tree_map(one, grads, residual)
    return _pick(out, 0), _pick(out, 1)
