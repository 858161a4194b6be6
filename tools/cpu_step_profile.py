#!/usr/bin/env python3
"""Where the CPU's time goes in a float32 train step at full width, the
reference side of ``chip_smoke.py``'s train parity phases.

  python3 tools/cpu_step_profile.py [--arch llama3.2-1b --layers 2 --batch 2 --seq 256]

Runs on the CPU only (the weights are made from seed 1 on the CPU, the
batches from ``PackedStream(1)`` as in ``train_parity``).  Prints the host's
cores and torch's threads; the seconds of two warm-up steps and of a third
under torch.profiler with its operators by self CPU time; then AdamW over
the model's params, three ways, each on fresh copies of the same state:
the reference's formula written out of place, ``optim.adamw_update``, and
``adamw_update`` inside ``chip_smoke.host_heap`` (large blocks from glibc's
heap instead of a fresh mmap each), with whether the three give the same
bits.  A full-width model needs tens of GiB of host memory: run it on a
machine that has them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def formula_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """AdamW as the reference writes it, every operation out of place."""
    import torch
    t = (state["step"] + 1).to(torch.float32)
    bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    out = {}
    for k, p in params.items():
        g, m, v = grads[k], state["m"][k], state["v"][k]
        m[...] = b1 * m + (1 - b1) * g
        v[...] = b2 * v + (1 - b2) * torch.square(g)
        out[k] = p - lr * (m / bc1 / (torch.sqrt(v / bc2) + eps) + wd * p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config (a quick check)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from repro_torch import models
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_map, tree_paths

    print(f"cores {os.cpu_count()}, torch threads {torch.get_num_threads()}, "
          f"torch {torch.__version__}")
    cfg = dataclasses.replace((get_smoke_config if args.smoke else get_config)(args.arch),
                              n_layers=args.layers, dtype="float32")
    params = tree_map(lambda t: t.requires_grad_(True),
                      models.init_params(cfg, torch.Generator().manual_seed(1)))
    batches = chip_smoke.train_batches(torch, cfg, args.batch, args.seq, 3, seed=1,
                                       device="cpu")
    state = adamw_init(params)
    step = make_train_step(cfg, base_lr=3e-4, warmup=10, total_steps=20)
    for i in range(2):
        t0 = time.time()
        params, state, _ = step(params, state, batches[i])
        print(f"step {i}: {time.time() - t0:.2f} s")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time()
        params, state, _ = step(params, state, batches[2])
        print(f"step 2 (profiled): {time.time() - t0:.2f} s")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15,
                                    max_name_column_width=40))

    flat = {k: p.detach() for k, p in tree_paths(params)}
    n = sum(p.numel() for p in flat.values())
    gen = torch.Generator().manual_seed(2)
    grads = {k: torch.randn(p.shape, generator=gen) * 1e-3 for k, p in flat.items()}
    m0 = {k: torch.rand(p.shape, generator=gen) * 1e-3 for k, p in flat.items()}
    v0 = {k: torch.rand(p.shape, generator=gen) * 1e-6 for k, p in flat.items()}
    fresh = lambda: {"m": {k: t.clone() for k, t in m0.items()},
                     "v": {k: t.clone() for k, t in v0.items()},
                     "step": torch.tensor(2, dtype=torch.int32)}
    lr = torch.tensor(3e-5)
    results = {}
    for name in ("formula", "adamw_update", "adamw_update in host_heap"):
        st = fresh()
        ctx = chip_smoke.host_heap() if "heap" in name else contextlib.nullcontext()
        with ctx:
            t0 = time.time()
            if name == "formula":
                new = formula_update(flat, grads, st, lr)
            else:
                new, st = adamw_update(flat, grads, st, lr=lr)
            secs = time.time() - t0
        results[name] = (new, st)
        print(f"AdamW over {n / 1e6:.1f} M params, {name}: {secs:.3f} s")
    ref = results["formula"]
    same = all(torch.equal(results[k][0][p], ref[0][p]) and torch.equal(results[k][1]["m"][p],
                                                                       ref[1]["m"][p])
               and torch.equal(results[k][1]["v"][p], ref[1]["v"][p])
               for k in results for p in flat)
    print(f"the three AdamW updates bit-equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
