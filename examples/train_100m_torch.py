"""End-to-end training example on the PyTorch port: a ~100M-param member
of the smollm family (10 layers, d_model 640, remat off) on the synthetic
packed-token pipeline (PackedStream, seed 0), with async checkpoints; the
loss must fall.  The counterpart of ``examples/train_100m.py``.

On the card the step is ``CompiledTrainStep``, the train step captured
once as a CUDA graph with its params and optimizer state updated in place
(``--eager`` runs the eager ``make_train_step`` on the card instead, the
yardstick); ``--device cpu`` runs the eager step on the CPU.

  PYTHONPATH=src python examples/train_100m_torch.py [--steps N]
  PYTHONPATH=src python examples/train_100m_torch.py --device cpu --steps 25
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def smollm_100m():
    """smollm-360m's family cut to ~100M params, as ``train_100m.py``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("smollm-360m"),
        name="smollm-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=5, head_dim=64, d_ff=2560, max_seq=2048,
        fsdp_axes=("data",), remat=False)


def main(argv=None):
    """Returns {"losses": [...], "step_s": [...] (host seconds a step, the
    loss read), "step": "captured" or "eager", "last": (the step function,
    params, optimizer state, the last batch)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--eager", action="store_true",
                    help="run the eager step on the card instead of the captured one")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.data import PackedStream
    from repro_torch.launch.steps import (CompiledTrainStep, init_train_state,
                                          make_train_step)
    from repro_torch.models.common import resolve_device

    cfg = smollm_100m()
    device = resolve_device(args.device)
    print(f"training {cfg.name}: ~{cfg.n_params() / 1e6:.0f}M params on {device}")
    params, opt_state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0))
    hyper = dict(base_lr=3e-4, warmup=20, total_steps=args.steps)
    captured = device.type == "cuda" and not args.eager
    step_fn = (CompiledTrainStep(cfg, params, opt_state, **hyper) if captured
               else make_train_step(cfg, **hyper))
    stream = PackedStream(cfg.vocab_size, args.seq_len, seed=0)
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    losses, step_s = [], []
    for step in range(1, args.steps + 1):
        b = stream.next_batch(args.batch)
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
        t0 = time.time()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.time() - t0)
        if step % 10 == 0 or step == 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} ({step_s[-1]:.3f}s/step)")
        if step % 20 == 0:
            ckpt.save(step, (params, opt_state),
                      {"step": step, "data_state": stream.snapshot()})
    ckpt.wait()
    assert losses[-1] < losses[0], "loss must improve"
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "step_s": step_s, "step": "captured" if captured else "eager",
            "last": (step_fn, params, opt_state, batch)}


if __name__ == "__main__":
    main()
