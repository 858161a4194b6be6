"""Gradient compression for the data-parallel all-reduce: int8 + error
feedback.  Port of ``repro.runtime.compression``.

Each rank quantises its gradient to int8 against a per-tensor scale, and
carries the quantisation residual into the next step (error feedback).
``compressed_psum`` takes the MAX of the ranks' scales, requantises
against it, and sums the int32-widened codes, so the sum is exact in
integers; ``compressed_allreduce`` runs it over one mesh axis on each
rank's leading-dim shard.  Divisions are IEEE: by a 0-dim tensor on the
data's device (``t / python_float`` on a CUDA tensor is ``t * (1 / c)``).
``torch.round`` rounds half to even, as ``jnp.round`` does.  The train
step does not call it, as the reference's does not.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_from_paths, tree_map, tree_paths


def _div(t: torch.Tensor, c) -> torch.Tensor:
    """``t / c`` as an IEEE division, ``c`` a number or a 0-dim tensor."""
    return t / torch.as_tensor(c, dtype=torch.float32, device=t.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x32 = x.to(torch.float32)
    scale = _div(torch.clamp(torch.max(torch.abs(x32)), min=1e-9), 127.0)
    q = torch.clamp(torch.round(_div(x32, scale)), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _pairs(fn, grads, error_state):
    """``fn(g, e)`` -> (a, b) over the leaves: (tree of a, tree of b)."""
    items = [(path, fn(g, e)) for (path, g), (_, e)
             in zip(tree_paths(grads), tree_paths(error_state))]
    return (tree_from_paths((p, ab[0]) for p, ab in items),
            tree_from_paths((p, ab[1]) for p, ab in items))


def compress_with_feedback(grads, error_state):
    """-> (quantised tree of ``{"q", "scale"}``, new error state); the
    error state mirrors the grads (float32 residuals)."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        return {"q": q, "scale": s}, g32 - dequantize_int8(q, s)
    return _pairs(one, grads, error_state)


def decompress(qtree):
    if set(qtree) == {"q", "scale"} and not isinstance(qtree["q"], dict):
        return dequantize_int8(qtree["q"], qtree["scale"])
    return {k: decompress(v) for k, v in qtree.items()}


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_psum(grads, error_state, group=None):
    """int8 all-reduce over the ranks of ``group`` (the default group if
    None): quantise locally with feedback, MAX-all-reduce the scale,
    requantise against it, SUM-all-reduce the int32 codes, dequantise with
    the shared scale.  -> (summed grads in their dtypes, new error state).
    A collective: every rank of the group calls it with the same tree."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        _, s = quantize_int8(g32)
        s_max = s.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        # requantise against the shared scale so the sum is exact in int32
        q2 = torch.clamp(torch.round(_div(g32, s_max)), -127, 127).to(torch.int32)
        total = q2.clone()
        dist.all_reduce(total, group=group)
        new_e = g32 - q2.to(torch.float32) * s_max
        return (total.to(torch.float32) * s_max).to(g.dtype), new_e
    return _pairs(one, grads, error_state)


def compressed_allreduce(grads, error_state, mesh, axis_name: str):
    """:func:`compressed_psum` over the ranks of ``mesh``'s axis
    ``axis_name``.  ``grads`` / ``error_state``: this rank's shards of
    trees whose leaves are cut on their leading dim over that axis; returns
    this rank's shards of (the reduced grads, the new error state), every
    rank's reduced shard the same sum."""
    return compressed_psum(grads, error_state, mesh.get_group(axis_name))
