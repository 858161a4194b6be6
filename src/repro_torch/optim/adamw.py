"""AdamW with float32 moments over the params' dtype; port of
``repro.optim.adamw``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params):
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(tree_leaves(params)).device),
    }


# elements of a leaf updated at once: a stacked leaf (mamba2-2.7b's in_proj,
# 64 x 2560 x 10576) is updated a slice of its leading dim at a time, so
# its float32 temporaries stay ~1 GB instead of several of its size
SLICE_ELEMENTS = 1 << 26


def _slices(p):
    """Indices of ``p`` covering it: slices of its leading dim of at most
    ~SLICE_ELEMENTS elements each, or the whole (``...``) of a small
    leaf."""
    if p.dim() == 0 or p.numel() <= SLICE_ELEMENTS:
        return [...]
    step = max(1, SLICE_ELEMENTS // max(1, p[0].numel()))
    return [slice(i, i + step) for i in range(0, p.shape[0], step)]


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, donate=False):
    """One step: returns (new params, new state).  ``lr`` is a float or a
    0-dim float32 tensor; the math runs in float32 and each result is cast
    to its param's dtype.  The moments ``m`` and ``v`` are updated IN PLACE
    and returned in the new state (the reference's driver donates its
    state, ``donate_argnums=(0, 1)``, to the same end: at mamba2-2.7b's 2.83
    B params a second copy of the float32 moments would not fit the card);
    the params are new tensors, or with ``donate`` the given ones updated in
    place, as is the state's ``step`` (the same bits either way).  The
    arithmetic is the reference's, element by element:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)

    each operation rounded once to float32 in that order, written with
    in-place operations on three temporaries a slice (a memory-bound pass
    and a fresh allocation fewer for each one left out)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        out = p if donate else torch.empty_like(p)
        for sl in _slices(p):
            g32 = g[sl].to(torch.float32)
            ms, vs = m[sl], v[sl]
            ms.mul_(b1).add_((1 - b1) * g32)
            vs.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
            delta = torch.div(ms, bc1).div_(torch.div(vs, bc2).sqrt_().add_(eps))
            p32 = p[sl].to(torch.float32)
            delta.add_(weight_decay * p32).mul_(lr)
            out[sl] = torch.sub(p32, delta, out=delta)
        return out

    new = tree_map(upd, params, grads, state["m"], state["v"])
    if donate:
        state["step"].copy_(step)
        return params, state
    return new, {"m": state["m"], "v": state["v"], "step": step}
