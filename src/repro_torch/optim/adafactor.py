"""Adafactor (Shazeer & Stern, 2018): factored second moments.

Port of ``repro.optim.adafactor``: a leaf whose last two dims are both at
least ``min_dim_factored`` keeps row and column statistics (``vr`` /
``vc``) instead of a full ``v``; no momentum; the step is clipped to RMS
``clip_threshold``; β2 = 1 − t^(−decay).  The update clipping takes one
RMS over each of ``update``'s ``groups`` (the layers of a run, which the
reference stacks in one leaf) and over every other leaf alone."""
from __future__ import annotations

import torch

from repro_torch.optim.common import (
    Optimizer, partition_leaves, tree_leaves, tree_map,
)


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_factored: int = 128,
              weight_decay: float = 0.0) -> Optimizer:
    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        dev = tree_leaves(params)[0].device
        return {"stats": tree_map(one, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, lr, groups=None):
        count = state["count"] + 1
        beta2 = 1.0 - count.to(torch.float32) ** (-decay)

        def direction(g, st):
            """The unclipped step of one leaf; its statistics updated."""
            gf = g.float()
            g2 = gf * gf + eps
            if "vr" in st:
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=-2)
                r = vr / vr.mean(dim=-1, keepdim=True)
                u = gf / (torch.sqrt(r)[..., None]
                          * torch.sqrt(vc)[..., None, :])
                st["vr"].copy_(vr)
                st["vc"].copy_(vc)
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                u = gf / torch.sqrt(v)
                st["v"].copy_(v)
            return u

        # the stats tree has one dict more at each leaf: walk the grads
        leaves = {}
        _walk(lambda key, g, p, st: leaves.__setitem__(key, (g, p, st)),
              grads, params, state["stats"])
        for group in partition_leaves(leaves, groups):
            us = [direction(leaves[k][0], leaves[k][2]) for k in group]
            # update clipping (RMS of the group's step ≤ clip_threshold)
            ss = torch.stack([torch.sum(u * u) for u in us]).sum()
            rms = torch.sqrt(ss / sum(u.numel() for u in us))
            clip = torch.clamp(rms / clip_threshold, min=1.0)
            for k, u in zip(group, us):
                p = leaves[k][1]
                p_new = p.float() - lr * (u / clip)
                if weight_decay:
                    p_new = p_new - lr * weight_decay * p.float()
                p.copy_(p_new)
        state["count"] = count
        return params, state

    return Optimizer(init=init, update=update)


def _walk(fn, grads, params, stats, prefix: str = "") -> None:
    """``fn(path, g, p, st)`` over the parameter leaves (paths as
    :func:`~repro_torch.optim.common.tree_flatten`'s); ``stats`` holds a
    dict ({"vr", "vc"} or {"v"}) where the parameters hold a tensor."""
    if isinstance(grads, dict):
        for k in grads:
            _walk(fn, grads[k], params[k], stats[k],
                  f"{prefix}.{k}" if prefix else k)
    else:
        fn(prefix, grads, params, stats)
