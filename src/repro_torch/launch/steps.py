"""Step functions of the serving path: prefill_step and serve_step (decode),
with greedy sampling.  Port of ``make_prefill_step`` / ``make_serve_step``
of ``repro.launch.steps``."""
from __future__ import annotations

import torch

from repro_torch import models


def make_prefill_step(cfg, *, kv_max: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, cache = models.forward(cfg, params, batch["tokens"],
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
