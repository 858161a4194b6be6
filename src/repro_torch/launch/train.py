"""End-to-end training driver; port of ``repro.launch.train``.

Runs a training loop on one device, the CUDA card unless ``--device``
names another.  On the card the step is ``launch.steps.CompiledTrainStep``:
captured once as a CUDA graph over one params tree and one optimizer
state, updated in place (the reference jits its step with both donated);
a restored checkpoint, and the fresh state of a restart without one, are
copied into those tensors, so one graph serves the whole run.
``--device cpu`` runs the eager ``make_train_step`` on the kernels' plain
versions.  The loss is read on the host every step, as the reference
blocks on it.  Fault tolerance: periodic async checkpoints (the
reference's format), restart from the latest one with the data cursor,
optional injected failures to exercise the restart policy.  There is no
mesh and no sharding context: the multi-device layer is still to be
ported (ROADMAP §A6).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 30 --seq-len 64 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --steps 30 --simulate-failures 1 --save-every 10
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import PackedStream
from repro_torch.launch.steps import (CompiledTrainStep, init_train_state,
                                      make_train_step)
from repro_torch.models.common import count_params, resolve_device
from repro_torch.runtime import RestartPolicy, StragglerDetector, WorkerFailure


def _batch(cfg, stream, batch: int, step: int, device):
    """The stream's next batch on ``device`` (token ids as int64), with
    the zero image prefix / random frame embeddings the reference gives a
    VLM / an encoder-decoder."""
    batch_np = stream.next_batch(batch)
    if cfg.n_prefix_tokens:
        batch_np["prefix_embeds"] = np.zeros(
            (batch, cfg.n_prefix_tokens, cfg.d_model), np.float32)
    if cfg.is_encoder_decoder:
        batch_np["encoder_embeds"] = np.random.default_rng(step).normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failures", type=int, default=0,
                    help="inject N worker failures to exercise restart")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)

    def fresh_state():
        return init_train_state(cfg, torch.Generator(device=device).manual_seed(args.seed))

    params, opt_state = fresh_state()
    hyper = dict(base_lr=args.lr, warmup=10, total_steps=args.steps)
    if device.type == "cuda":
        train_step = CompiledTrainStep(cfg, params, opt_state, **hyper)

        def adopt(new_params, new_state):
            return train_step.load(new_params, new_state)
    else:
        train_step = make_train_step(cfg, **hyper)

        def adopt(new_params, new_state):
            return new_params, new_state
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"arch={cfg.name} params={count_params(params)/1e6:.1f}M device={where} "
          f"step={'captured' if device.type == 'cuda' else 'eager'}")

    stream = PackedStream(cfg.vocab_size, args.seq_len, seed=args.seed)
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    policy = RestartPolicy()
    detector = StragglerDetector(n_workers=1)

    start = 0
    if latest_step(args.ckpt_dir) is not None:
        (params, opt_state), extras = restore(args.ckpt_dir, (params, opt_state))
        params, opt_state = adopt(params, opt_state)
        start = extras.get("step", 0)
        if "data_state" in extras:
            stream.restore(extras["data_state"])
        print(f"restored from checkpoint at step {start}")

    failures_left = args.simulate_failures
    step = start
    losses = []
    while step < args.steps:
        batch = _batch(cfg, stream, args.batch, step, device)
        t0 = time.time()
        try:
            if failures_left and step == start + 5:
                failures_left -= 1
                raise WorkerFailure(0, "(injected)")
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
        except WorkerFailure:
            now = time.time()
            policy.record_failure(now)
            if not policy.should_restart(now):
                raise
            ckpt.wait()
            if latest_step(args.ckpt_dir) is not None:
                (params, opt_state), extras = restore(args.ckpt_dir, (params, opt_state))
                params, opt_state = adopt(params, opt_state)
                step = extras.get("step", 0)
                if "data_state" in extras:
                    stream.restore(extras["data_state"])
                print(f"[ft] restarted from step {step}")
            else:
                params, opt_state = adopt(*fresh_state())
                step = 0
                print("[ft] no checkpoint; restarted from scratch")
            continue
        detector.record(0, time.time() - t0)
        step += 1
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"dt {time.time()-t0:.2f}s")
        if step % args.save_every == 0:
            ckpt.save(step, (params, opt_state),
                      {"step": step, "data_state": stream.snapshot()})
    ckpt.wait()
    assert losses and losses[-1] < losses[0], \
        f"loss did not improve: {losses[0]:.3f} -> {losses[-1]:.3f}"
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
