"""Step functions of the serving path: prefill_step and serve_step (decode),
with greedy sampling.  Port of ``make_prefill_step`` / ``make_serve_step``
of ``repro.launch.steps``, and ``CompiledServeStep``, the serve step
captured once as a CUDA graph: the counterpart of the reference's
``jax.jit(serve_step, donate_argnums=(1,))`` in ``launch/serve.py``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import models
from repro_torch.kernels._build import LAUNCHES, LAUNCHES_BY_SHAPE


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
