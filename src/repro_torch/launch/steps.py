"""Step functions: train_step, prefill_step and serve_step (decode), with
greedy sampling.  Port of ``repro.launch.steps``: ``cross_entropy``,
``make_loss_fn``, ``make_train_step``, ``init_train_state``,
``make_prefill_step`` and ``make_serve_step``; and ``CompiledServeStep``,
the serve step captured once as a CUDA graph: the counterpart of the
reference's ``jax.jit(serve_step, donate_argnums=(1,))`` in
``launch/serve.py``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import models
from repro_torch.kernels._build import LAUNCHES, LAUNCHES_BY_SHAPE
from repro_torch.optim import clip_by_global_norm, linear_warmup_cosine, make_optimizer
from repro_torch.tree import tree_from_paths, tree_map, tree_paths

# the RRAM weight noise's seed of a step: (NOISE_SEED, step), as the
# reference folds the step into PRNGKey(17)
NOISE_SEED = 17


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE: float32 logsumexp, masked mean over ``mask``."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def _noisy(leaf) -> bool:
    """The leaves the RRAM noise multiplies: floating, >= 2 dims."""
    return leaf.is_floating_point() and leaf.ndim >= 2


def weight_noise(params, std: float, step: int):
    """The RRAM noise factors ``1 + std * N(0, 1)`` (float32) of every
    leaf that takes noise (None elsewhere), drawn from a generator seeded
    by (NOISE_SEED, step) on the params' device, one leaf after the other
    in the JAX package's order.  The draws are the port's own, not JAX's
    (the distributions are the same)."""
    items = list(tree_paths(params))
    dev = items[0][1].device
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED * 1_000_003 + int(step))
    return tree_from_paths(
        (path, 1 + std * torch.randn(leaf.shape, generator=gen, device=dev,
                                     dtype=torch.float32) if _noisy(leaf) else None)
        for path, leaf in items)


def make_loss_fn(cfg, *, weight_noise_std: float = 0.0):
    """weight_noise_std > 0 enables the paper's noise-resilient training
    (§IV / [13]): multiplicative Gaussian noise on the weights during the
    forward pass models RRAM conductance relaxation.

    ``loss_fn(params, batch, step=None, noise=None)`` -> (loss, {"ce",
    "aux"}).  With noise on, ``noise`` is a tree of factors with the
    params' nesting (``weight_noise`` gives the port's own; a test may
    pass the JAX package's), else the factors are drawn for ``step`` (an
    int, or a 0-dim tensor, which is then read on the host to seed the
    generator).  A leaf becomes ``leaf * factor.to(leaf.dtype)``, as the
    reference casts ``1 + std * normal`` to the leaf's dtype."""
    def loss_fn(params, batch, step=None, noise=None):
        p = params
        if weight_noise_std > 0.0 and (noise is not None or step is not None):
            if noise is None:
                noise = weight_noise(params, weight_noise_std, int(step))
            p = tree_map(lambda l, f: l if f is None or not _noisy(l) else l * f.to(l.dtype),
                         params, noise)
        logits, aux, _ = models.forward(cfg, p, batch["tokens"],
                                        prefix_embeds=batch.get("prefix_embeds"),
                                        encoder_embeds=batch.get("encoder_embeds"))
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg, *, base_lr=3e-4, warmup=100, total_steps=10000,
                    max_grad_norm=1.0, weight_noise_std: float = 0.0):
    """``train_step(params, opt_state, batch, noise=None)`` -> (params,
    opt_state, metrics): the loss and its gradient by autograd (through
    ``kernels.flash_attention.FlashAttentionFn`` and
    ``kernels.ssd_scan.SSDScanFn`` on the card), global-norm clipping, the
    warmup-cosine LR of the state's step and the config's optimizer.
    Params are leaves that require grad; the new ones are too.  The
    optimizer may update its state in place (AdamW's moments).  The update
    runs under ``torch.no_grad()``; metrics (``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``) are 0-dim tensors, read by nobody here.
    ``noise``: the RRAM noise factors for this step (see
    ``make_loss_fn``); by default drawn for the state's step."""
    loss_fn = make_loss_fn(cfg, weight_noise_std=weight_noise_std)
    _, opt_update = make_optimizer(cfg.optimizer)

    def train_step(params, opt_state, batch, noise=None):
        params = tree_map(lambda p: p if p.requires_grad else p.detach().requires_grad_(True),
                          params)
        paths, leaves = zip(*tree_paths(params))
        with torch.enable_grad():
            loss, parts = loss_fn(params, batch, step=opt_state["step"], noise=noise)
            grad_leaves = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = tree_from_paths(
                (path, torch.zeros_like(leaf) if g is None else g)
                for path, leaf, g in zip(paths, leaves, grad_leaves))
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr = linear_warmup_cosine(opt_state["step"].to(torch.float32),
                                      base_lr=base_lr, warmup_steps=warmup,
                                      total_steps=total_steps)
            params, opt_state = opt_update(params, grads, opt_state, lr=lr)
        params = tree_map(lambda p: p.requires_grad_(True), params)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg, gen: torch.Generator):
    """Random params from ``gen`` on its device (leaves that require grad)
    and the config's optimizer state."""
    params = tree_map(lambda p: p.requires_grad_(True), models.init_params(cfg, gen))
    opt_init, _ = make_optimizer(cfg.optimizer)
    return params, opt_init(params)


def make_prefill_step(cfg, *, kv_max: int):
    """``batch``: ``tokens`` (B, S), ``prefix_embeds`` (B, P, d) for a
    prefix-LM (paligemma's patch embeddings; the cache then holds P + S
    rows) and ``encoder_embeds`` (B, S_enc, d) for an encoder-decoder
    (whisper)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, cache = models.forward(cfg, params, batch["tokens"],
                                          prefix_embeds=batch.get("prefix_embeds"),
                                          encoder_embeds=batch.get("encoder_embeds"),
                                          collect_cache=True, kv_max=kv_max)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
        return next_tok, cache
    return prefill_step


def make_serve_step(cfg):
    """One decode step: append token, attend over the cache, greedy-sample
    the next token.  The cache is updated in place."""
    @torch.no_grad()
    def serve_step(params, cache, token, cache_len):
        logits, cache = models.decode_step(cfg, params, token, cache,
                                           cache_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
        return next_tok, cache
    return serve_step


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def tensor_addresses(*trees) -> Dict[str, Tuple]:
    """Each tensor of the trees by its path: (address, shape, dtype), what
    a captured graph reads and writes."""
    return {f"{i}{path}": (t.data_ptr(), tuple(t.shape), t.dtype)
            for i, tree in enumerate(trees) for path, t in _leaves(tree)}


def _attention_rows(cache):
    """Rows of the contiguous self-attention cache (never the cross
    cache's), or None for a model without attention (its decode reads no
    length)."""
    for entry in cache.values():
        if "k" in entry:
            return entry["k"].shape[2]
    return None


class CompiledServeStep:
    """The serve step captured once as a CUDA graph over one params tree
    and one cache, the counterpart of the reference's jitted step with its
    cache donated: ``cache_len`` is a 0-dim device tensor inside the graph
    (one graph serves every length), the cache is updated in place at its
    own addresses, and the token, length and next token live in static
    buffers.

    Building it runs one eager step first (kernel builds, kernel
    attributes, cuBLAS heuristics, the allocator), on a copy of the cache
    so the cache is left as it was, then captures the step.  A call copies
    the token and length into the static buffers, replays the graph and
    returns ``(next_token, cache)``; ``next_token`` is the static output,
    overwritten by the next call, so copy it to keep it.  A call whose
    params or cache are not the captured tensors raises: the graph would
    read or write the captured addresses.  A failed capture or replay
    raises; nothing falls back to the eager step.

    ``kernels.ops.LAUNCHES`` (and ``LAUNCHES_BY_SHAPE``) count a kernel
    launch when its wrapper runs, which for a graph is during capture; the
    capture's counts are taken back and added again on every replay, so
    the counters read as the eager step's would.  ``logits`` is the static (B, 1, V) output of the
    last call."""

    def __init__(self, cfg, params, cache, batch: int):
        self.device = next(_leaves(cache))[1].device
        if self.device.type != "cuda":
            raise ValueError("CompiledServeStep captures a CUDA graph: it "
                             "takes a cache on a CUDA device")
        self.max_len = _attention_rows(cache)
        self.token = torch.zeros((batch, 1), dtype=torch.long,
                                 device=self.device)
        self.cache_len = torch.ones((), dtype=torch.long, device=self.device)
        self.addresses = tensor_addresses(params, cache)

        def step(c):
            logits, _ = models.decode_step(cfg, params, self.token, c,
                                           self.cache_len)
            return logits, torch.argmax(logits[:, -1:], dim=-1)

        with torch.no_grad():
            step({k: {n: t.clone() for n, t in e.items()}
                  for k, e in cache.items()})                   # warm-up
            torch.cuda.synchronize(self.device)
            counts, shapes = dict(LAUNCHES), dict(LAUNCHES_BY_SHAPE)
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph):
                    self.logits, self.next_token = step(cache)
            finally:
                self.launches = {k: LAUNCHES[k] - counts[k] for k in LAUNCHES}
                self.launches_by_shape = {
                    k: n - shapes.get(k, 0) for k, n in LAUNCHES_BY_SHAPE.items()
                    if n != shapes.get(k, 0)}
                LAUNCHES.update(counts)
                LAUNCHES_BY_SHAPE.clear()
                LAUNCHES_BY_SHAPE.update(shapes)

    def __call__(self, params, cache, token, cache_len: int):
        if tensor_addresses(params, cache) != self.addresses:
            raise ValueError("CompiledServeStep: params or cache are not the "
                             "tensors the graph was captured on; build a new "
                             "step for them")
        if self.max_len is not None and not 1 <= cache_len <= self.max_len:
            raise ValueError(f"cache_len {cache_len} outside [1, {self.max_len}]")
        self.token.copy_(token)
        self.cache_len.fill_(cache_len)
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n
        for key, n in self.launches_by_shape.items():
            LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + n
        return self.next_token, cache
