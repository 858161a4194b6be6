"""Mixture-of-Experts with capacity-based dispatch.

Port of ``repro.models.moe``, with its semantics: a float32 router, top-k
of its logits with the gates a softmax over those k, the Switch aux loss
from the full softmax; a dense path for few tokens (every expert on every
token, combined through the top-k gate mask); otherwise a per-batch-row
dispatch into ``(B, E, C, d)`` buffers, token-major priority over the
flattened ``S * k`` choices, choices at or past the capacity ``C``
dropped, a batched expert FFN and a gate-weighted combine.

No value is read on the host on either path (no boolean-mask indexing, no
``.item()``, no ``one_hot`` of unknown width): dropped choices are written
to a spare slot of the buffer that the FFN never reads and read back as
zero, so the sublayer can be captured in a CUDA graph.  There is no Pallas
kernel here; the expert products are batched matmuls, as in the JAX
package.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import batch_mean, current

from .common import ACTS, dense_init, dtype_of

DENSE_TOKEN_THRESHOLD = 32   # at or below this many tokens: the dense path


def init_moe(cfg, gen: torch.Generator, *, n_stack: int = 0):
    """Router ``(d, E)`` float32 and experts stacked ``(E, d, f)`` / ``(E,
    f, d)`` (fan-in taken from the leading dim, as the JAX package does),
    plus the ``shared`` experts ``(S, d, f)`` / ``(S, f, d)`` when the
    config has any."""
    m = cfg.moe
    dt = dtype_of(cfg)
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": dense_init(gen, (d, E), torch.float32, scale=d ** -0.5,
                             n_stack=n_stack),
        "w_gate": dense_init(gen, (E, d, f), dt, n_stack=n_stack),
        "w_up": dense_init(gen, (E, d, f), dt, n_stack=n_stack),
        "w_down": dense_init(gen, (E, f, d), dt, n_stack=n_stack),
    }
    if m.n_shared_experts:
        S = m.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (S, d, f), dt, n_stack=n_stack),
            "w_up": dense_init(gen, (S, d, f), dt, n_stack=n_stack),
            "w_down": dense_init(gen, (S, f, d), dt, n_stack=n_stack),
        }
    return p


def _capacity(S: int, E: int, k: int, cf: float) -> int:
    return max(k, int(-(-S * k * cf // E)))


def _all_experts(act, x, p, gate=None):
    """Every expert of ``p`` on every token, each weighted by its ``gate``
    (B, S, E) if given: x (B, S, d) -> (B, S, d) in x's dtype.  The gate
    and up products are one batched product an expert weight, read in
    place (an einsum over the stacked (E, d, f) weights copies them into
    another layout first); the down product contracts the experts and f
    together, one matmul over ``E * f`` rounded once, as the reference's
    einsum ``bsef,efd->bsd`` does (per-expert products would round each
    expert's output to bf16 before the sum)."""
    B, S, d = x.shape
    E, f, _ = p["w_down"].shape
    xt = x.reshape(1, B * S, d)
    h = act(torch.matmul(xt, p["w_gate"])) * torch.matmul(xt, p["w_up"])  # (E, BS, f)
    if gate is not None:
        h = h * gate.reshape(B * S, E).T.to(h.dtype)[..., None]
    h = h.transpose(0, 1).reshape(B * S, E * f)
    return (h @ p["w_down"].reshape(E * f, d)).reshape(B, S, d)


def moe_sublayer(cfg, p, x, *, with_aux: bool = True):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux_loss float32 scalar,
    or None without ``with_aux``: a decode step takes none).

    Under a sharding context whose data-parallel axes hold more than one
    rank, x is this rank's shard of the batch and the aux loss is the
    global batch's, the same on every rank, as the reference's under
    GSPMD: the routed and probability fractions are means over the ranks
    (``sharding.batch_mean``), the probabilities' gradient reaching this
    rank's own router once."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    C = _capacity(S, E, k, m.capacity_factor)
    act = ACTS[cfg.mlp]

    logits = x.float() @ p["router"]                           # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(logits, k, dim=-1)             # (B, S, k)
    gates = torch.softmax(gate_vals, dim=-1)                   # renorm over top-k

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e / k
    experts = torch.arange(E, device=x.device)
    sel_onehot = (idx[..., None] == experts).float()           # (B, S, k, E)
    aux = None
    if with_aux:
        frac_routed = sel_onehot.sum(2).mean(dim=(0, 1))       # (E,)
        frac_prob = probs.mean(dim=(0, 1))
        ctx = current()
        groups = ctx.dp_groups() if ctx is not None else ()
        if groups:
            frac_routed = batch_mean(frac_routed, groups)
            frac_prob = batch_mean(frac_prob, groups)
        aux = E * torch.sum(frac_routed * frac_prob) / k

    if B * S <= DENSE_TOKEN_THRESHOLD:
        # few tokens (a decode step): every expert densely, combined through
        # the top-k gate mask
        gate_full = (sel_onehot * gates[..., None]).sum(2)     # (B, S, E)
        y = _all_experts(act, x, p, gate_full)
    else:
        # per batch row: a choice's slot in its expert's buffer is the count
        # of earlier choices (token-major over the S * k choices) of that
        # expert; choices at pos >= C are dropped
        flat_e = idx.reshape(B, S * k)                         # (B, S*k)
        onehot = (flat_e[..., None] == experts).long()         # (B, S*k, E)
        pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
        within = pos < C
        # the dropped go to a spare slot C of each expert, never read
        slot = flat_e * (C + 1) + torch.clamp(pos, max=C)      # (B, S*k)
        x_rep = x.repeat_interleave(k, dim=1)                  # (B, S*k, d)
        buf = x.new_zeros((B, E * (C + 1), d))
        buf.scatter_(1, slot[..., None].expand(B, S * k, d), x_rep)
        buf = buf.view(B, E, C + 1, d)[:, :, :C]               # (B, E, C, d)

        h = act(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
        h = h * torch.einsum("becd,edf->becf", buf, p["w_up"])
        y_buf = torch.einsum("becf,efd->becd", h, p["w_down"])  # (B, E, C, d)

        read = flat_e * C + torch.clamp(pos, max=C - 1)
        got = torch.gather(y_buf.reshape(B, E * C, d), 1,
                           read[..., None].expand(B, S * k, d))
        got = torch.where(within[..., None], got, torch.zeros_like(got))
        weight = gates.reshape(B, S * k) * within
        got = got * weight.to(got.dtype)[..., None]
        y = got.reshape(B, S, k, d).sum(dim=2)

    if m.n_shared_experts:
        y = y + _all_experts(act, x, p["shared"])
    return y.to(x.dtype), aux
