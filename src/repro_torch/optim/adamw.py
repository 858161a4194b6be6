"""AdamW with float32 moments over the params' dtype; port of
``repro.optim.adamw``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_pick


def adamw_init(params):
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(tree_leaves(params)).device),
    }


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One step: returns (new params, new state).  ``lr`` is a float or a
    0-dim float32 tensor; the math runs in float32 and each result is cast
    to its param's dtype."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return tree_pick(out, 0), {"m": tree_pick(out, 1), "v": tree_pick(out, 2), "step": step}
