"""Serving driver: continuous-batched decode (PyTorch execution).

Port of ``repro.launch.serve``.  Requests arrive with prompts, are fed into
the cache (K/V, or conv and SSM state) through the decode step, and each
decode round advances ALL slots one token (continuous batching with slot
recycling), greedy sampling.  The semantics are the JAX ``Server``'s,
quirks included: one shared ``cur_len`` for all slots; admission sets
``cur_len = max(cur_len + 1, len(prompt))``, so a prompt's first token
attends over zero cache rows; every admission step is a full-batch decode
that writes K/V into every slot, and advances every slot's recurrent state
for an SSM; only slot ``i``'s next token is taken during admission; an
encoder-decoder (whisper) is served without its encoder, so every step
attends over a cross cache of zeros, and a prefix-LM (paligemma) without
its image prefix, its prompts admitted through the decode step as text
alone (the JAX ``Server`` runs neither; ROADMAP hazard 6).

On a CUDA device the server runs its decode step as one CUDA graph,
captured once over its params and cache (``CompiledServeStep``), as the
JAX ``Server`` runs one jitted step with the cache donated; reassigning
``params`` captures it anew.  On the CPU it runs the eager step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --n-requests 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \\
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.steps import CompiledServeStep, make_serve_step
from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class Slot:
    request_id: Optional[int] = None
    prompt_len: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = True


class Server:
    def __init__(self, cfg, *, max_batch: int = 4, max_len: int = 512,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = models.init_cache(cfg, max_batch, max_len,
                                       device=self.device)
        self.params = models.init_params(cfg, gen)
        self.slots = [Slot() for _ in range(max_batch)]
        self.cur_len = 0          # shared cache length (continuous batch)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.long,
                                  device=self.device)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        """New weights: on a card the step is captured anew over them (the
        old graph read the old tensors' addresses)."""
        self._params = params
        self.step_fn = None       # frees the old graph before the new one
        if self.device.type == "cuda":
            self.step_fn = CompiledServeStep(self.cfg, params, self.cache,
                                             self.max_batch)
        else:
            self.step_fn = make_serve_step(self.cfg)

    def admit(self, request_id: int, prompt: np.ndarray) -> bool:
        """Prefill a prompt into a free slot (per-slot prefill via the
        decode path keeps the cache layout uniform)."""
        free = [i for i, s in enumerate(self.slots) if s.done]
        if not free:
            return False
        i = free[0]
        self.slots[i] = Slot(request_id, len(prompt), [], False)
        for t in prompt:
            tok = self.tokens.clone()
            tok[i, 0] = int(t)
            self.cur_len = max(self.cur_len + 1, len(prompt))
            nxt, self.cache = self.step_fn(self.params, self.cache, tok,
                                           self.cur_len)
            self.tokens[i, 0] = nxt[i, 0]
        return True

    def decode_round(self):
        self.cur_len += 1
        nxt, self.cache = self.step_fn(self.params, self.cache, self.tokens,
                                       self.cur_len)
        self.tokens.copy_(nxt)    # nxt may be the graph's static output
        ids = nxt[:, 0].tolist()
        for i, s in enumerate(self.slots):
            if not s.done:
                s.generated.append(ids[i])

    def active(self) -> int:
        return sum(not s.done for s in self.slots)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    srv = Server(cfg, max_batch=args.n_requests, max_len=args.max_len,
                 device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.n_requests):
        prompt = rng.integers(2, cfg.vocab_size, size=8)
        srv.admit(rid, prompt)
    for _ in range(args.max_new):
        srv.decode_round()
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(srv.device)
             if srv.device.type == "cuda" else "cpu")
    total_tokens = sum(len(s.generated) for s in srv.slots)
    print(f"served {args.n_requests} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {where})")
    for s in srv.slots:
        assert len(s.generated) == args.max_new
        assert all(0 <= t < cfg.vocab_size for t in s.generated)
    print("OK")


if __name__ == "__main__":
    main()
