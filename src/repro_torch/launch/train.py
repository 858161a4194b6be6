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
optional injected failures to exercise the restart policy.

Started as several ranks (``torchrun``, ``WORLD_SIZE`` > 1), it trains
data-parallel as the reference's driver does over its mesh: gloo process
group (on the card too: NCCL refuses two ranks on one card), the host
mesh ``make_host_mesh`` ((ranks, 1) over ("data", "model")),
``activation_rules(cfg, mesh, "train")`` in a ``ShardingCtx``, the state
cut by ``param_specs`` / ``opt_state_specs``, and the eager
``make_sharded_train_step``.  Every rank draws the same global
``PackedStream`` batch and keeps its ``batch_specs`` shard, so the data
cursor stays one; rank 0 writes the gathered state in the reference's
checkpoint format, and a restore cuts it again on every rank.  Each line
a rank prints starts with its rank.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 30 --seq-len 64 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --steps 30 --simulate-failures 1 --save-every 10
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch smollm-360m --smoke --device cpu \
      --steps 12 --seq-len 64 --batch 4 --simulate-failures 1 --save-every 4
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import PackedStream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (CompiledTrainStep, gather_train_state, init_train_state,
                                      make_sharded_train_step, make_train_step,
                                      shard_train_state)
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


class _DataParallel:
    """This run's ranks when the launcher started several: the process
    group, the host mesh and its sharding context, the state's specs, and
    the cuts and gathers of state and batch."""

    def __init__(self, cfg, device):
        if device.type == "cuda":           # every rank on its card, or all on the one
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group("gloo")
        self.cfg = cfg
        self.rank = dist.get_rank()
        self.mesh = make_host_mesh(device.type)
        self.ctx = sharding.ShardingCtx(self.mesh,
                                        sharding.activation_rules(cfg, self.mesh, "train"))
        self.n_dp = sharding.axes_size(self.mesh, sharding.dp_axes(self.mesh))
        self.pspecs = self.ospecs = None

    def cut(self, params, opt_state):
        """This rank's shards of the global state (the specs taken from the
        first state cut)."""
        if self.pspecs is None:
            self.pspecs = sharding.param_specs(self.cfg, params, self.mesh, "train")
            self.ospecs = sharding.opt_state_specs(self.cfg, opt_state, self.pspecs, self.mesh)
        return shard_train_state(params, opt_state, self.pspecs, self.ospecs, self.mesh)

    def gather(self, params, opt_state):
        return gather_train_state(params, opt_state, self.pspecs, self.ospecs, self.mesh)

    def batch(self, batch):
        if next(iter(batch.values())).shape[0] % self.n_dp:
            raise ValueError(f"--batch must split over the {self.n_dp} data-parallel ranks")
        specs = sharding.batch_specs(self.cfg, batch, self.mesh)
        return {k: sharding.local_shard(v, specs[k], self.mesh) for k, v in batch.items()}

    def close(self):
        dist.barrier()                      # no rank tears gloo down while another still talks
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch (every rank's shards together)")
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

    dp = _DataParallel(cfg, device) if int(os.environ.get("WORLD_SIZE", "1")) > 1 else None
    params, opt_state = fresh_state()
    n_params = count_params(params)
    hyper = dict(base_lr=args.lr, warmup=10, total_steps=args.steps)
    if dp is not None:
        params, opt_state = dp.cut(params, opt_state)
        train_step = make_sharded_train_step(cfg, dp.ctx, dp.pspecs, dp.ospecs, **hyper)
        adopt, kind = dp.cut, f"data-parallel over {dist.get_world_size()} ranks, eager"
    elif device.type == "cuda":
        train_step = CompiledTrainStep(cfg, params, opt_state, **hyper)
        adopt, kind = train_step.load, "captured"
    else:
        train_step = make_train_step(cfg, **hyper)
        adopt, kind = (lambda p, s: (p, s)), "eager"
    prefix = f"[rank {dp.rank}] " if dp is not None else ""

    def say(line):
        print(prefix + line + "\n", end="", flush=True)   # one write a line: ranks share stdout

    device = opt_state["step"].device
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M device={where} step={kind}")

    stream = PackedStream(cfg.vocab_size, args.seq_len, seed=args.seed)
    writer = dp is None or dp.rank == 0
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    policy = RestartPolicy()
    detector = StragglerDetector(n_workers=1)

    def save(step):
        state = (params, opt_state) if dp is None else dp.gather(params, opt_state)
        if writer:
            ckpt.save(step, state, {"step": step, "data_state": stream.snapshot()})

    def settle():
        """Every rank sees the checkpoints rank 0 has written."""
        if writer:
            ckpt.wait()
        if dp is not None:
            dist.barrier()

    def restore_latest():
        like = (params, opt_state) if dp is None else dp.gather(params, opt_state)
        (p, s), extras = restore(args.ckpt_dir, like)
        if "data_state" in extras:
            stream.restore(extras["data_state"])
        return (*adopt(p, s), extras.get("step", 0))

    start = 0
    settle()
    if latest_step(args.ckpt_dir) is not None:
        params, opt_state, start = restore_latest()
        say(f"restored from checkpoint at step {start}")

    failures_left = args.simulate_failures
    step = start
    losses = []
    while step < args.steps:
        batch = _batch(cfg, stream, args.batch, step, device)
        if dp is not None:
            batch = dp.batch(batch)
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
            settle()
            if latest_step(args.ckpt_dir) is not None:
                params, opt_state, step = restore_latest()
                say(f"[ft] restarted from step {step}")
            else:
                params, opt_state = adopt(*fresh_state())
                step = 0
                say("[ft] no checkpoint; restarted from scratch")
            continue
        detector.record(0, time.time() - t0)
        step += 1
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            say(f"step {step:5d} loss {loss:.4f} "
                f"ce {float(metrics['ce']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"dt {time.time()-t0:.2f}s")
        if step % args.save_every == 0:
            save(step)
    settle()
    if dp is not None:
        dp.close()
    assert losses and losses[-1] < losses[0], \
        f"loss did not improve: {losses[0]:.3f} -> {losses[-1]:.3f}"
    say(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
