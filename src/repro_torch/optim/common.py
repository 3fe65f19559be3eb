"""Functional optimizer interface and gradient utilities.

Port of ``repro.optim.common``.  A tree is a dict of tensors, nested
dicts allowed: the port's parameters are ``dict(model.named_parameters())``
(the names of ``Model.state_dict()``), and every optimizer state is a tree
of the same keys.  Unlike the reference's pure functions, ``update``
writes the new parameters and state into the tensors it is given (the
parameters are the model's own, so the model sees the step) and returns
them: on the card this keeps one copy of the parameters and the moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) → state;  update(grads, state, params, lr) →
    (params, state), updated in place."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in fp32 (a 0-d tensor)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm
