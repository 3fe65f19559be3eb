"""AdamW with configurable state dtype (fp32 default; bf16 for memory).

Port of ``repro.optim.adamw``: the moments are stored in ``state_dtype``
and every update is computed in fp32.  It takes no statistic over a
leaf, so ``update``'s ``groups`` change nothing."""
from __future__ import annotations

import torch

from repro_torch.optim.common import Optimizer, tree_leaves, tree_map


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, lr, groups=None):
        count = state["count"] + 1
        cf = count.to(torch.float32)
        c1 = 1.0 - b1 ** cf
        c2 = 1.0 - b2 ** cf

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            step = step + weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m_new)
            v.copy_(v_new)

        tree_map(upd, grads, state["m"], state["v"], params)
        state["count"] = count
        return params, state

    return Optimizer(init=init, update=update)
