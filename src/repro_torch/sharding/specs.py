"""Partition specs for params / optimizer state / caches / batches.

Port of ``repro.sharding.specs``, with its rules (``dp_axes``, ``_best_dim``
with its strict ``s > best_size``, ``_spec_with`` trimming trailing
``None``s, the three modes):
  * ``train`` / ``prefill``: ZeRO-3/FSDP, every weight cut on its largest
    evenly-divisible dim over ``cfg.fsdp_axes`` (optionally Megatron-style
    MLP tensor parallelism, ``mlp_tp``).
  * ``decode``: weights persistently cut on their largest dim over
    ``model``; MoE experts over ``model`` / ``data``.
  * KV caches SEQUENCE-cut over ``model`` (over ``("data", "model")`` for
    the long-context shape).

A spec is a :class:`Spec`: a tuple with one entry a dimension, ``None`` or
a tuple of mesh axis names, the first axis the major one, as in JAX's
``P(("data", "model"))``.  The functions read only the mesh's axis sizes:
they take a ``DeviceMesh`` or a plain ``{name: size}`` mapping (so a 512-rank
mesh can be asked about in one process), and trees (nested dicts) whose
leaves have a ``.shape``: tensors, meta tensors, numpy arrays.
``to_placements`` turns a spec into DTensor placements;
``sharding.layout.local_shard`` / ``gather_shard`` cut a tensor by a spec
and put it back together.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

from repro_torch.tree import tree_from_paths, tree_paths


class Spec(tuple):
    """One entry a dimension: ``None`` or a tuple of mesh axis names; a
    name alone is taken as a tuple of one, so ``Spec("model")`` equals
    ``Spec(("model",))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            None if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``size(dim)``), or of a mapping as given."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _axes_size(shape: Mapping[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(shape[a] for a in axes) if axes else 1


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _best_dim(shape, skip_dims, divisor) -> int:
    """Largest dim (by size) not in skip_dims divisible by divisor; -1 if none."""
    best, best_size = -1, 0
    for i, s in enumerate(shape):
        if i in skip_dims:
            continue
        if s % divisor == 0 and s >= divisor and s > best_size:
            best, best_size = i, s
    return best


def _spec_with(ndim, assignments: Dict[int, Any]) -> Spec:
    entries = [assignments.get(i) for i in range(ndim)]
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def _map_paths(fn, tree):
    """``fn(path string, leaf)`` over the leaves, as a tree of the results."""
    return tree_from_paths((path, fn(_path_str(path), leaf)) for path, leaf in tree_paths(tree))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def param_specs(cfg, params, mesh, mode: str, mlp_tp: bool = False):
    """Tree of :class:`Spec` matching ``params``.

    mlp_tp: Megatron-style tensor parallelism for the MLP weights in
    training (d_ff dim over "model")."""
    ms = mesh_shape(mesh)
    fsdp = tuple(a for a in cfg.fsdp_axes if a in ms)
    fsdp_div = _axes_size(ms, fsdp)
    model_div = ms.get("model", 1)
    data_div = ms.get("data", 1)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        stacked = ("layers" in ps) and len(shape) >= 2
        skip = {0} if stacked else set()

        if len(shape) <= 1:
            return Spec()

        is_expert = ("moe" in ps and "router" not in ps and
                     len(shape) - (1 if stacked else 0) >= 3)
        leaf_name = ps.split("/")[-1].strip("'[]")

        if mode == "train" and mlp_tp and leaf_name in (
                "w_gate", "w_up", "w_down") and not is_expert:
            off = 1 if stacked else 0
            # w_gate/w_up: (..., d, f) -> shard f (last); w_down: (..., f, d)
            ff_dim = len(shape) - 1 if leaf_name in ("w_gate", "w_up") else off
            if shape[ff_dim] % model_div == 0:
                a = {ff_dim: ("model",)}
                # shard the other big dim over "data" (ZeRO-ish)
                other = off if ff_dim != off else len(shape) - 1
                if shape[other] % data_div == 0:
                    a[other] = ("data",)
                return _spec_with(len(shape), a)

        if mode in ("train", "prefill"):
            if is_expert:
                # shard expert dim over fsdp axes if divisible, else inner
                e_dim = 1 if stacked else 0
                if shape[e_dim] % fsdp_div == 0:
                    return _spec_with(len(shape), {e_dim: fsdp})
                d = _best_dim(shape, skip | {e_dim}, fsdp_div)
                if d >= 0:
                    return _spec_with(len(shape), {d: fsdp})
            d = _best_dim(shape, skip, fsdp_div)
            if d >= 0:
                return _spec_with(len(shape), {d: fsdp})
            d = _best_dim(shape, skip, model_div)
            if d >= 0:
                return _spec_with(len(shape), {d: ("model",)})
            return Spec()

        # mode == "decode": persistent TP / EP
        if is_expert:
            e_dim = 1 if stacked else 0
            E = shape[e_dim]
            # prefer the MOST sharding: a 400B expert stack needs both axes
            if E % (data_div * model_div) == 0:
                return _spec_with(len(shape), {e_dim: ("data", "model")})
            if E % data_div == 0:
                inner = _best_dim(shape, skip | {e_dim}, model_div)
                a = {e_dim: ("data",)}
                if inner >= 0:
                    a[inner] = ("model",)
                return _spec_with(len(shape), a)
            if E % model_div == 0:
                return _spec_with(len(shape), {e_dim: ("model",)})
        d = _best_dim(shape, skip, model_div)
        if d >= 0:
            return _spec_with(len(shape), {d: ("model",)})
        return Spec()

    return _map_paths(one, params)


def opt_state_specs(cfg, opt_state, params_specs, mesh,
                    opt_axes: Tuple[str, ...] = ("data", "model")):
    """Optimizer-state specs: always ZeRO-cut over ``opt_axes``, however the
    params themselves are cut (``params_specs`` is taken, as the
    reference takes it, and not read)."""
    ms = mesh_shape(mesh)
    axes = tuple(a for a in opt_axes if a in ms)
    div = _axes_size(ms, axes)
    model_div = ms.get("model", 1)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return Spec()
        stacked = "layers" in ps and len(shape) >= 2
        skip = {0} if stacked else set()
        d = _best_dim(shape, skip, div)
        if d >= 0:
            return _spec_with(len(shape), {d: axes})
        d = _best_dim(shape, skip, model_div)
        return _spec_with(len(shape), {d: ("model",)}) if d >= 0 else Spec()

    return _map_paths(one, opt_state)


# ---------------------------------------------------------------------------
# Cache / batch specs
# ---------------------------------------------------------------------------

def cache_specs(cfg, cache, mesh, *, long_context: bool = False):
    """Cache leaves: k/v (G, B, S, H, D) seq-cut over model (PICNIC
    distributed scratchpad), over (data, model) for the long-context
    batch-1 shape; also whisper's cross cache and a mamba block's SSM
    heads / conv channels over model.  Not what PICNIC decode cuts:
    ``sharding.layout.local_cache`` cuts only the batch and the k/v rows."""
    ms = mesh_shape(mesh)
    dp = dp_axes(ms)
    dpsize = _axes_size(ms, dp)
    model_div = ms.get("model", 1)
    seq_axes = ("data", "model") if long_context else ("model",)
    seq_div = _axes_size(ms, seq_axes)

    def one(ps, leaf):
        name = ps.split("/")[-1]
        shape = tuple(leaf.shape)
        a: Dict[int, Any] = {}
        B = shape[1] if len(shape) >= 2 else 0
        if B and B % dpsize == 0:
            a[1] = dp
        elif B and B % ms.get("data", 1) == 0:
            a[1] = ("data",)
        if name in ("k", "v"):
            if shape[2] % seq_div == 0:
                a[2] = seq_axes
            elif shape[2] % model_div == 0:
                a[2] = ("model",)
        elif name in ("cross_k", "cross_v"):
            if shape[3] % model_div == 0:   # heads (20 not div 16 -> skip)
                a[3] = ("model",)
        elif name == "ssm":
            if shape[2] % model_div == 0:   # heads
                a[2] = ("model",)
        elif name == "conv":
            if shape[3] % model_div == 0:   # conv channels
                a[3] = ("model",)
        return _spec_with(len(shape), a)

    return _map_paths(one, cache)


def batch_specs(cfg, batch, mesh):
    """Every batch leaf cut on dim 0 over the dp axes where it divides,
    else over ``data``, else replicated."""
    ms = mesh_shape(mesh)
    dp = dp_axes(ms)
    dpsize = _axes_size(ms, dp)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        a: Dict[int, Any] = {}
        if len(shape) >= 1 and shape[0] % dpsize == 0:
            a[0] = dp
        elif len(shape) >= 1 and shape[0] % ms.get("data", 1) == 0:
            a[0] = ("data",)
        return _spec_with(len(shape), a)

    return _map_paths(one, batch)


# ---------------------------------------------------------------------------
# Activation rules (read by shard_hint through ShardingCtx)
# ---------------------------------------------------------------------------

def activation_rules(cfg, mesh, mode: str, *,
                     long_context: bool = False) -> Dict[str, Spec]:
    ms = mesh_shape(mesh)
    dp = dp_axes(ms)
    seq_axes = ("data", "model") if long_context else ("model",)
    model_div = ms.get("model", 1)
    # MoE dispatch buffers (B, E, C, d): E over "model" when it divides,
    # else the capacity dim
    if cfg.moe and cfg.moe.n_experts % model_div == 0:
        moe_buf = Spec(dp, ("model",))
    else:
        moe_buf = Spec(dp, None, ("model",))
    if mode in ("train", "prefill"):
        # sequence parallel: batch over dp, seq over "model"
        return {
            "act_btd": Spec(dp, ("model",)),
            "act_ffn": Spec(dp, ("model",)),
            "act_heads": Spec(dp, ("model",)),      # q stays seq-cut
            "act_kv_heads": Spec(dp),               # k/v gathered (GQA-small)
            "logits": Spec(dp, ("model",)),
            "moe_buffer": moe_buf,
            "moe_ffn": Spec(dp, None, None, ("model",)),
            "ssm_heads": Spec(dp),
        }
    # decode
    return {
        "act_btd": Spec(dp),
        "act_ffn": Spec(dp, None, ("model",)),
        "act_heads": Spec(dp),
        "act_kv_heads": Spec(dp),
        "kv_cache": Spec(None, dp, seq_axes),
        "logits": Spec(dp, None, ("model",)),
        "moe_buffer": Spec(dp, ("model",)) if (cfg.moe and
            cfg.moe.n_experts % model_div == 0) else Spec(dp),
        "moe_ffn": Spec(dp),
        "ssm_heads": Spec(dp, None, ("model",)),
    }


def to_placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``), one a
    mesh dim: ``Shard(d)`` where dim d's entry names that axis, else
    ``Replicate()``; a tree of specs gives a tree of placements (the
    counterpart of the reference's ``to_named``).  DTensor cuts a dim over
    several mesh dims in the mesh's order, the first the major one: an
    entry that names its axes in another order is refused."""
    if isinstance(spec, dict):
        return {k: to_placements(v, mesh) for k, v in spec.items()}
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in entry]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec} names its axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)
