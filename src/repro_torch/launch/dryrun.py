"""Multi-pod dry run: cost every (arch x shape x mesh) cell on fake tensors.

Port of ``repro.launch.dryrun``.  For each cell this
  1. makes one process rank 0 of a fake world of 256 or 512 ranks
     (``fake_world``: ``torch.distributed``'s ``"fake"`` backend) and the
     production mesh over it on the CPU (16x16 single-pod / 2x16x16
     multi-pod),
  2. takes the param / optimizer / cache / batch specs
     (``repro_torch.sharding.specs``) and cuts this rank's shards out of
     fake full-size inputs (``launch.input_specs``),
  3. runs the port's own step function once on them under
     ``launch.cost.count`` -- nothing is allocated on any device,
  4. records the counted FLOPs, bytes, kernel work and per-collective wire
     bytes, the analytic HBM bytes and the H100 roofline terms
     (``launch.roofline``) into artifacts/dryrun_torch/<cell>.json.

The port has no tensor parallelism: a step gathers the params that the
reference's specs cut (an all-gather a leaf), and a baseline decode also
the cache's sequence cut, where GSPMD partitions the matmuls instead.  The
``picnic`` variant runs the port's sequence-parallel attention (train,
prefill) and PICNIC decode (each rank's partials, combined by all-reduces)
on the cache shard ``sharding.local_cache`` cuts; ``fsdp16`` cuts the
weights over ``model`` only, ``mlptp`` takes the MLP specs of Megatron's
tensor parallelism (the port gathers them all the same), and ``pp`` is
the GPipe train step (``launch.pipeline``) over the ``pod`` axis, costed
at the first and at the last stage (only the last computes the loss), the
larger count recorded.

A record holds the reference's keys, except: ``flop_counter``
(``FlopCounterMode``'s own total of the same run) in place of
``xla_cost_analysis``; ``memory`` holds the rank's ``argument_bytes``,
``output_bytes`` and ``alias_bytes`` (the donated params and optimizer
state, or cache) from its local shards, ``temp_bytes`` the counter's peak
live bytes, and ``code_bytes`` None; ``count_s`` is the seconds of the
counted run (there is nothing to lower or compile); ``kernels`` the kernel
launches and their work.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape decode_32k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import cost as cost_mod
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import pipeline as pp
from repro_torch.launch import roofline as rl
from repro_torch.launch.collective_capture import parse_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_sharded_train_step)
from repro_torch.optim import make_optimizer
from repro_torch.sharding import specs as sp
from repro_torch.sharding import (ShardingCtx, full_shape, gather_shard, local_cache,
                                  local_shard, use_sharding)
from repro_torch.tree import tree_from_paths, tree_paths

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def fake_world(world_size: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake world of ``world_size``
    ranks (``torch.distributed``'s ``"fake"`` backend: collectives return
    at once and move nothing).  One process holds one world: an existing
    fake world of the same size is kept (at another rank it is made anew),
    and a world of another size or backend is refused with ``ValueError``."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(f"torch {torch.__version__} has no fake process group "
                          "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        size, backend = dist.get_world_size(), dist.get_backend()
        if size != world_size or backend != "fake":
            raise ValueError(f"this process already holds a {backend} world of {size} ranks; "
                             f"a fake world of {world_size} needs a process of its own")
        if dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def cell_mesh(mesh_name: str, rank: int = 0):
    """The CPU ``DeviceMesh`` of ``mesh_name`` ("pod1", "pod2", or a spec
    as ``collective_capture.parse_mesh`` reads it) over a fake world in
    which this process is ``rank``."""
    if mesh_name in ("pod1", "pod2"):
        fake_world(512 if mesh_name == "pod2" else 256, rank)
        return make_production_mesh(multi_pod=mesh_name == "pod2", device_type="cpu")
    sizes, axes = parse_mesh(mesh_name)
    fake_world(math.prod(sizes), rank)
    return init_device_mesh("cpu", sizes, mesh_dim_names=axes)


def cell_applicable(cfg, shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k-token decode is "
                       "quadratic/unbounded-KV; skipped per assignment "
                       "(see DESIGN.md §6)")
    return True, ""


def _shards(tree, specs, mesh):
    spec_of = dict(tree_paths(specs))
    return tree_from_paths((path, local_shard(leaf, spec_of[path], mesh))
                           for path, leaf in tree_paths(tree))


def _gather(tree, specs, mesh):
    spec_of = dict(tree_paths(specs))
    return tree_from_paths(
        (path, gather_shard(leaf, spec_of[path], mesh,
                            full_shape(leaf.shape, spec_of[path], mesh)))
        for path, leaf in tree_paths(tree))


def _but_batch(spec):
    """``spec`` without its batch entry (dim 1 of a cache leaf)."""
    return sp.Spec(*(None if d == 1 else e for d, e in enumerate(spec)))


def build_cell(cfg, shape, mesh, *, opt_variant: str = "baseline"):
    """Returns (fn, args, donated): the port's step on this rank's shards
    and those shards (fake tensors); ``donated`` the indices of the args
    the step takes in place of its outputs."""
    long_ctx = shape.name == "long_500k"
    mode = {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]
    rules = sp.activation_rules(cfg, mesh, mode, long_context=long_ctx)
    seq_axes = ("data", "model") if long_ctx else ("model",)
    options = {}
    if opt_variant.startswith("picnic"):
        options = {
            "sp_attention": mode in ("train", "prefill"),
            "picnic_decode": mode == "decode",
            "seq_axes": seq_axes,
            "dp_axes": sp.dp_axes(mesh),
        }
    if "fsdp16" in opt_variant:
        cfg = dataclasses.replace(cfg, fsdp_axes=("model",))
    ctx = ShardingCtx(mesh, rules, options)

    pshapes = ispec.params_shapes(cfg)
    pspecs = sp.param_specs(cfg, pshapes, mesh, mode, mlp_tp="mlptp" in opt_variant)
    with ispec.fake_mode():
        if shape.kind == "train" and opt_variant == "pp":
            if "pod" not in sp.mesh_shape(mesh):
                raise ValueError("the pp variant needs the multi-pod mesh")
            step = pp.make_pp_train_step(cfg, mesh, stage_axis="pod", n_micro=8,
                                         dp_axes=("data",))
            opt_init, _ = make_optimizer(cfg.optimizer)
            oshapes = opt_init(pshapes)
            ppspecs = pp.pp_specs(cfg, pshapes, mesh, "pod")
            ospecs = pp.pp_opt_state_specs(cfg, oshapes, "pod")
            tokens = torch.empty((shape.global_batch, shape.seq_len), dtype=torch.int32)
            return step, (_shards(pshapes, ppspecs, mesh), _shards(oshapes, ospecs, mesh),
                          tokens), (0, 1)

        if shape.kind == "train":
            opt_init, _ = make_optimizer(cfg.optimizer)
            oshapes = opt_init(pshapes)
            ospecs = sp.opt_state_specs(cfg, oshapes, pspecs, mesh)
            batch = ispec.train_batch_specs(cfg, shape)
            bspecs = sp.batch_specs(cfg, batch, mesh)
            step = make_sharded_train_step(cfg, ctx, pspecs, ospecs)
            return step, (_shards(pshapes, pspecs, mesh), _shards(oshapes, ospecs, mesh),
                          _shards(batch, bspecs, mesh)), (0, 1)

        if shape.kind == "prefill":
            step = make_prefill_step(cfg, kv_max=shape.seq_len)
            batch = ispec.prefill_batch_specs(cfg, shape)
            bspecs = sp.batch_specs(cfg, batch, mesh)

            def prefill(params, b):
                with use_sharding(ctx):
                    return step(_gather(params, pspecs, mesh), b)
            return prefill, (_shards(pshapes, pspecs, mesh), _shards(batch, bspecs, mesh)), ()

        step = make_serve_step(cfg)
        token, cshapes, clen = ispec.decode_arg_specs(cfg, shape)
        tspec = sp.batch_specs(cfg, {"token": token}, mesh)["token"]
        if options.get("picnic_decode"):
            cache = local_cache(cshapes, mesh, seq_axes=seq_axes, dp_axes=sp.dp_axes(mesh))

            def decode(params, c, tok, cache_len):
                with use_sharding(ctx):
                    return step(_gather(params, pspecs, mesh), c, tok, cache_len)
        else:
            cspecs = sp.cache_specs(cfg, cshapes, mesh, long_context=long_ctx)
            cache = _shards(cshapes, cspecs, mesh)
            whole = tree_from_paths((path, _but_batch(s)) for path, s in tree_paths(cspecs))

            def decode(params, c, tok, cache_len):
                with use_sharding(ctx):
                    tok, c = step(_gather(params, pspecs, mesh), _gather(c, whole, mesh), tok,
                                  cache_len)
                return tok, _shards(c, whole, mesh)
        return decode, (_shards(pshapes, pspecs, mesh), cache, local_shard(token, tspec, mesh),
                        clen), (1,)


def cost_cell(cfg, shape, mesh_name: str, opt_variant: str = "baseline"):
    """(Cost, memory dict, mesh sizes, seconds) of one cell on its rank: rank
    0, and for ``pp`` the first or the last stage's rank, whichever counts
    more FLOPs."""
    ranks = [0]
    if opt_variant == "pp" and shape.kind == "train":
        mesh = cell_mesh(mesh_name)
        n_pod = sp.mesh_shape(mesh).get("pod", 1)
        ranks.append(dist.get_world_size() // n_pod * (n_pod - 1))
    best = None
    for rank in ranks:
        mesh = cell_mesh(mesh_name, rank)
        fn, args, donated = build_cell(cfg, shape, mesh, opt_variant=opt_variant)
        t0 = time.time()
        out, c = cost_mod.run_counted(fn, *args)
        seconds = time.time() - t0
        memory = dict(argument_bytes=cost_mod.tree_bytes(args),
                      output_bytes=cost_mod.tree_bytes(out), temp_bytes=int(c.peak_bytes),
                      code_bytes=None,
                      alias_bytes=cost_mod.tree_bytes([args[i] for i in donated]))
        if best is None or c.flops > best[0].flops:
            best = (c, memory, sp.mesh_shape(mesh), seconds, rank)
    return best


def run_cell(arch: str, shape_name: str, mesh_name: str,
             opt_variant: str = "baseline", save: bool = True, smoke: bool = False):
    """One cell's record.  ``mesh_name``: "pod1" (16 x 16), "pod2" (2 x 16 x
    16), or a spec as "2x2x2"; ``smoke`` takes the CPU-sized config."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
           "mesh": mesh_name, "variant": opt_variant}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, save)
        return rec

    try:
        c, memory, mesh_shape, seconds, rank = cost_cell(cfg, shape, mesh_name, opt_variant)
        nchips = math.prod(mesh_shape.values())
        mode = {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]
        bytes_acc = rl.analytic_memory_bytes(cfg, shape, mesh_shape, mode)
        dtype = "float32" if cfg.dtype == "float32" else "bfloat16"
        terms = rl.roofline_terms(c.flops, bytes_acc, c.wire_bytes, dtype)
        mflops = rl.model_flops(cfg, shape) / nchips
        rec.update(
            status="ok", count_s=round(seconds, 2), nchips=nchips, rank=rank,
            memory=memory,
            flops_per_chip=c.flops,
            bytes_per_chip=bytes_acc,
            hlo_bytes_upper=c.bytes,
            flop_counter=float(c.flop_counter),
            kernels=c.kernels,
            collectives=c.coll,
            wire_bytes_per_chip=c.wire_bytes,
            roofline=terms,
            dominant=rl.dominant_term(terms),
            model_flops_per_chip=mflops,
            useful_flop_frac=(mflops / c.flops if c.flops else None),
        )
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-12000:])
    _save(rec, save)
    return rec


def _save(rec, save):
    if not save:
        return
    ART.mkdir(parents=True, exist_ok=True)
    name = f"{rec['cell']}" + (
        "" if rec.get("variant", "baseline") == "baseline"
        else f"__{rec['variant']}")
    with open(ART / f"{name}.json", "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args()

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        assert args.arch and args.shape
        cells = [(args.arch, args.shape)]

    n_ok = n_skip = n_err = 0
    for mesh_name in meshes:
        if dist.is_initialized():       # each mesh its own fake world
            dist.destroy_process_group()
        for arch, shape in cells:
            t0 = time.time()
            rec = run_cell(arch, shape, mesh_name, args.variant)
            dt = time.time() - t0
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_err += st == "error"
            dom = rec.get("dominant", "-")
            print(f"[{st:7s}] {rec['cell']:60s} {dt:7.1f}s dom={dom}",
                  flush=True)
            if st == "error":
                print("   ", rec["error"][:300], flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}", flush=True)


if __name__ == "__main__":
    main()
