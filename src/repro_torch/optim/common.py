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
    """init(params) → state;  update(grads, state, params, lr,
    groups=None) → (params, state), updated in place.  ``groups`` lists
    leaf paths (:func:`tree_flatten`'s keys) that share one per-tensor
    statistic, as :func:`partition_leaves` reads it."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of nested dicts, paths joined by "." (the keys of a
    flat tree such as ``dict(model.named_parameters())`` are its paths)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict = {}
    for k, v in tree.items():
        out.update(tree_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def tree_unflatten(like, flat: dict, prefix: str = ""):
    """A tree of ``like``'s structure holding ``flat``'s leaves by path."""
    if not isinstance(like, dict):
        return flat[prefix]
    return {k: tree_unflatten(v, flat, f"{prefix}.{k}" if prefix else k)
            for k, v in like.items()}


def partition_leaves(paths, groups=None) -> list[list[str]]:
    """``paths`` cut into the groups that share a per-tensor statistic:
    each of ``groups`` (lists of paths, as
    :func:`repro_torch.bridge.leaf_groups` gives them for a model's
    parameters), then every path no group holds on its own."""
    paths = list(paths)
    known, out, seen = set(paths), [], set()
    for group in groups or ():
        missing = [k for k in group if k not in known or k in seen]
        if missing:
            raise ValueError(f"group {group}: paths {missing} are unknown or "
                             f"in another group")
        seen.update(group)
        out.append(list(group))
    return out + [[k] for k in paths if k not in seen]


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
