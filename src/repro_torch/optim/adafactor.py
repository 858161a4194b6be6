"""Adafactor (factored second moment, no momentum); port of
``repro.optim.adafactor``.  State: ``{"v": {...}, "step"}`` where ``v``
has the params' nesting and holds, for each param, ``{"vr", "vc"}`` (a
param of >= 2 dims: row and column means of g^2) or ``{"v"}``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_pick


def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params):
    def init(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}
    return {"v": tree_map(init, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(tree_leaves(params)).device)}


@torch.no_grad()
def adafactor_update(params, grads, state, *, lr, b2=0.999, eps=1e-30,
                     weight_decay=0.0, clip_threshold=1.0, donate=False):
    """One step: returns (new params, new state); float32 math, each result
    cast to its param's dtype.  With ``donate`` the results are written
    into the given params and state tensors, which are returned (the same
    bits as the new tensors)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2t = 1.0 - torch.pow(t, -0.8)

    def upd(p, g, s):
        g32 = g.to(torch.float32)
        g2 = torch.square(g32) + eps
        if _factored(p.shape):
            vr = beta2t * s["vr"] + (1 - beta2t) * g2.mean(dim=-1)
            vc = beta2t * s["vc"] + (1 - beta2t) * g2.mean(dim=-2)
            rfac = (vr / vr.mean(dim=-1, keepdim=True))[..., None]
            u = g32 * torch.rsqrt(rfac * vc[..., None, :] + eps)
            news = {"vr": vr, "vc": vc}
        else:
            v = beta2t * s["v"] + (1 - beta2t) * g2
            u = g32 * torch.rsqrt(v + eps)
            news = {"v": v}
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.square(u).mean() + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        newp = p.to(torch.float32) - lr * u
        if weight_decay:
            newp -= lr * weight_decay * p.to(torch.float32)
        if donate:
            p.copy_(newp)
            for k, t in news.items():
                s[k].copy_(t)
            return p, s
        return newp.to(p.dtype), news

    # the params' nesting leads: at each param, state["v"] holds its dict
    out = tree_map(upd, params, grads, state["v"])
    if donate:
        state["step"].copy_(step)
        return params, state
    return tree_pick(out, 0), {"v": tree_pick(out, 1), "step": step}
