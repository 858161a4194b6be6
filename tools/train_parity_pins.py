#!/usr/bin/env python3
"""Find where a float32 train step's card/CPU gap comes from: zamba2-2.7b's
widths at two groups (chip_smoke.py's hybrid_train_parity: 12 mamba layers,
2 applications of the shared block, SSD chunk 64, B2 x S512 of
PackedStream(1), 3 AdamW steps at lr 3e-4, warmup 10), the CPU once, then
the card with the params and AdamW moments of a set of leaves copied from
the CPU's after each step.

  python3 tools/train_parity_pins.py

Prints per pin set (nothing; a_log and dt_bias; embed; those four leaves;
every leaf) each step's loss and gradient norm relative to the CPU's, the
leaves whose updates lie farthest from the CPU's, and, at the last step,
the pre-clip gradients at each run's own params: their norm relative to
the CPU's, the leaves farthest from the CPU's and the leaves whose squared
norm differs most.  Needs one card and ~40 GiB of host memory.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PIN_SETS = ((), ("a_log", "dt_bias"), ("embed",), ("a_log", "dt_bias", "d_skip", "embed"), "*")
N_STEPS = 3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_parity_pins: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import PackedStream
    from repro_torch.launch.steps import make_loss_fn, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map, tree_paths

    cfg0 = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(cfg0, n_layers=2 * cfg0.attn_every, dtype="float32",
                              ssm=dataclasses.replace(cfg0.ssm, chunk=64))
    params0 = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))

    def batches(dev):
        stream = PackedStream(cfg.vocab_size, 512, seed=1)
        out = []
        for _ in range(N_STEPS):
            b = stream.next_batch(2)
            out.append({"tokens": torch.from_numpy(b["tokens"]).long().to(dev),
                        "labels": torch.from_numpy(b["labels"]).long().to(dev),
                        "mask": torch.from_numpy(b["mask"]).to(dev)})
        return out

    def grads(p, batch):
        paths = list(tree_paths(p))
        loss, _ = make_loss_fn(cfg)(p, batch)
        return {k: g.detach().cpu()
                for (k, _), g in zip(paths, torch.autograd.grad(loss, [t for _, t in paths]))}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def run(dev, pin=(), record=False, pinned=None):
        p = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), params0)
        state = adamw_init(p)
        step = make_train_step(cfg, base_lr=3e-4, warmup=10, total_steps=20)
        metrics, updates, recs, last = [], [], [], None
        t0 = time.time()
        for i, batch in enumerate(batches(dev)):
            if i == N_STEPS - 1:
                last = grads(p, batch)
            before = {k: t.detach().cpu() for k, t in tree_paths(p)}
            p, state, m = step(p, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            updates.append({k: t.detach().cpu() - before[k] for k, t in tree_paths(p)})
            if i == N_STEPS - 1:
                break
            paths = [k for k, _ in tree_paths(p)]
            if record:
                recs.append({k: [leaf(t, k).detach().cpu().clone()
                                 for t in (p, state["m"], state["v"])] for k in paths})
            if pinned is not None:
                with torch.no_grad():
                    for k in paths:
                        if pin == "*" or k[-1] in pin:
                            for t, val in zip((p, state["m"], state["v"]), pinned[i][k]):
                                leaf(t, k).copy_(val)
        print(f"{dev} pin={pin}: {time.time() - t0:.1f}s", flush=True)
        return metrics, updates, recs, last

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def sq(g):
        return float(g.double().pow(2).sum())

    cpu = run("cpu", record=True)
    for pin in PIN_SETS:
        card = run("cuda", pin=pin, pinned=cpu[2])
        mrel = {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for a, b in zip(card[0], cpu[0])]
                for k in ("loss", "grad_norm")}
        print(f"pin={pin}: metrics rel per step " + ", ".join(
            f"{k} [" + ", ".join(f"{v:.3e}" for v in vs) + "]" for k, vs in mrel.items()))
        for i, (cu, pu) in enumerate(zip(card[1], cpu[1])):
            u = {k: rel(cu[k], pu[k]) if pu[k].any() else float(cu[k].abs().max()) for k in pu}
            top = sorted(u, key=u.get, reverse=True)[:4]
            print(f"  step {i} updates: " + ", ".join(f"{'/'.join(k)} {u[k]:.3e}" for k in top))
        gc, gp = card[3], cpu[3]
        r = {k: rel(gc[k], gp[k]) for k in gp}
        top = sorted(r, key=r.get, reverse=True)[:6]
        n2c, n2p = sum(sq(g) for g in gc.values()), sum(sq(g) for g in gp.values())
        print(f"  step {N_STEPS - 1} gradients at each run's params: norm rel "
              f"{abs(n2c ** .5 - n2p ** .5) / n2p ** .5:.3e}; leaves: "
              + ", ".join(f"{'/'.join(k)} {r[k]:.3e}" for k in top))
        d = {k: sq(gc[k]) - sq(gp[k]) for k in gp}
        topd = sorted(d, key=lambda k: abs(d[k]), reverse=True)[:6]
        print(f"  squared norm {n2c - n2p:.4e} apart of {n2p:.4e}; largest parts: "
              + ", ".join(f"{'/'.join(k)} {d[k]:.3e}" for k in topd), flush=True)
        del card
    return 0


if __name__ == "__main__":
    sys.exit(main())
