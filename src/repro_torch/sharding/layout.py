"""Where a rank sits on the mesh's axes, and its shards.

The reference lets GSPMD or ``shard_map`` cut a global array by a
``PartitionSpec`` and names a device's place with ``jax.lax.axis_index``;
the port runs one process a rank, on plain local tensors, and these
functions give the same numbers from a ``DeviceMesh``: the size of a set
of axes, the rank's index over them (the last axis fastest, as
``picnic_decode_attention`` composes it and as JAX orders ``P(("data",
"model"))``), their process groups; ``local_shard`` / ``gather_shard``, a
tensor cut by a ``sharding.specs.Spec`` and put back together; the mean of
equal batch shards over the ranks (``batch_mean``); and ``local_cache``,
the rank's shard of a global cache for PICNIC decode.

A mesh here is anything with ``mesh_dim_names``, ``size(dim)`` and
``get_local_rank(axis)`` (and ``get_group(axis)`` to gather).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def axes_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(_dim(mesh, a))
    return n


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index over ``axes`` taken together, the last the
    fastest: the shard of a dimension split over them that it holds."""
    idx, mult = 0, 1
    for a in reversed(tuple(axes)):
        idx += mesh.get_local_rank(a) * mult
        mult *= mesh.size(_dim(mesh, a))
    return idx


def axes_groups(mesh, axes: Sequence[str]):
    """The process group of each axis, in order."""
    return tuple(mesh.get_group(a) for a in axes)


def _cut(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split into {n}")
    step = t.shape[dim] // n
    return t.narrow(dim, i * step, step)


def full_shape(shape, spec, mesh) -> tuple:
    """The global shape of a shard of ``shape`` cut by ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry:
            out[d] *= axes_size(mesh, entry)
    return tuple(out)


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the global ``x`` cut by ``spec`` (one entry a
    dim: None, or the mesh axes that cut it, the first the major one), as
    a contiguous copy without grad."""
    x = x.detach()
    for d, entry in enumerate(spec):
        if entry:
            x = _cut(x, d, axes_size(mesh, entry), axes_index(mesh, entry))
    return x.clone(memory_format=torch.contiguous_format)


def _gather_dim(x: torch.Tensor, d: int, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim ``d`` in the
    axis's order (an all-gather, which gloo takes on CUDA tensors too,
    through the host)."""
    n = mesh.size(_dim(mesh, axis))
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=d)


def gather_shard(x: torch.Tensor, spec, mesh, full_shape) -> torch.Tensor:
    """``local_shard``'s inverse: the global tensor of shape
    ``full_shape`` from every rank's shard ``x``, gathered over each cut
    dim's axis groups, the fastest axis first.  A collective: every rank of
    those groups calls it."""
    x = x.detach()
    for d, entry in enumerate(spec):
        for axis in reversed(entry or ()):
            x = _gather_dim(x, d, mesh, axis)
    if tuple(x.shape) != tuple(full_shape):
        raise ValueError(f"gathered {tuple(x.shape)} by {spec}, expected {tuple(full_shape)}")
    return x


def batch_mean(t: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``groups``, each holding an
    equal shard of a batch (``t`` a statistic of its shard): the value is
    the mean of every rank's, the gradient reaches this rank's ``t`` once,
    scaled by 1 / ranks, so that a SUM of the ranks' gradients counts each
    shard once.  A collective."""
    total, n = t.detach().clone(), 1
    for g in groups:
        dist.all_reduce(total, group=g)
        n *= dist.get_world_size(g)
    return (total + (t - t.detach())) / n


def local_cache(cache, mesh, *, seq_axes=("model",), dp_axes=("data",)):
    """This rank's shard of a global cache (as ``models.init_cache`` or a
    prefill returns it) for PICNIC decode, as contiguous copies.  Not
    ``sharding.specs.cache_specs``, which also cuts cross-attention and SSM
    heads over ``model``: here every tensor's batch
    (dimension 1) over ``dp_axes`` where it divides (else replicated, as
    the reference's ``bspec``), and a self-attention cache's rows
    (``k`` / ``v``, dimension 2) over ``seq_axes``.  Whisper's cross cache
    and a mamba block's conv / SSM state are not cut in the sequence.  A
    batch cut over an axis that also cuts the sequence is refused, as the
    reference's PartitionSpec would be."""
    n_dp, n_seq = axes_size(mesh, dp_axes), axes_size(mesh, seq_axes)
    i_dp, i_seq = axes_index(mesh, dp_axes), axes_index(mesh, seq_axes)
    out = {}
    for key, entry in cache.items():
        out[key] = {}
        for name, t in entry.items():
            if t.shape[1] % n_dp == 0:
                if set(seq_axes) & set(dp_axes):
                    raise ValueError(f"a batch of {t.shape[1]} cut over {dp_axes} and the "
                                     f"sequence over {seq_axes}: they share an axis")
                t = _cut(t, 1, n_dp, i_dp)
            if name in ("k", "v"):
                t = _cut(t, 2, n_seq, i_seq)
            out[key][name] = t.clone(memory_format=torch.contiguous_format)
    return out
