"""Where a rank sits on the mesh's axes, and its shards.

The reference lets GSPMD or ``shard_map`` cut a global array by a
``PartitionSpec`` and names a device's place with ``jax.lax.axis_index``;
the port runs one process a rank, on plain local tensors, and these
functions give the same numbers from a ``DeviceMesh``: the size of a set
of axes, the rank's index over them (the last axis fastest, as
``picnic_decode_attention`` composes it and as JAX orders ``P(("data",
"model"))``), their process groups; ``local_shard`` / ``gather_shard``, a
tensor cut by a ``sharding.specs.Spec`` and put back together; the mean of
equal batch shards over the ranks (``batch_mean``); ``local_cache``, the
rank's shard of a global cache for PICNIC decode; the sequence cut of
sequence-parallel attention, ``seq_gather`` (every rank's rows, an
all-gather whose backward is a reduce-scatter) and ``seq_slice`` (this
rank's rows); and ``ppermute``, the pipeline's hand-off from stage to
stage.

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


class _SeqGather(torch.autograd.Function):
    """Every rank's rows of ``x`` over the seq axes, concatenated on ``dim``
    in ``axes_index``'s order; the backward is a reduce-scatter: the float32
    SUM over those ranks of each one's gradient of the whole, then this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.rows = mesh, axes, dim, x.shape[dim]
        for axis in reversed(axes):        # the fastest axis first, as gather_shard
            x = _gather_dim(x, dim, mesh, axis)
        return x

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32, copy=True).contiguous()
        for axis in ctx.axes:
            dist.all_reduce(g, group=ctx.mesh.get_group(axis))
        i = axes_index(ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, i * ctx.rows, ctx.rows).to(grad.dtype), None, None, None


def seq_gather(x: torch.Tensor, mesh, seq_axes: Sequence[str], dim: int = 1) -> torch.Tensor:
    """The whole sequence from every rank's rows ``x`` (this rank's are
    rows ``[i * n, (i + 1) * n)`` of dim ``dim``, i its ``axes_index`` over
    ``seq_axes``): an all-gather over the seq axes' groups, the last axis
    fastest, as the reference's ``sp_flash_attention`` gathers K and V.
    Differentiable: the gradient of this rank's rows is the SUM over the
    seq ranks of each one's gradient of those rows (a reduce-scatter, in
    float32).  A collective: every rank of those groups calls it."""
    return _SeqGather.apply(x, mesh, tuple(seq_axes), dim)


def seq_slice(x: torch.Tensor, mesh, seq_axes: Sequence[str], dim: int = 1) -> torch.Tensor:
    """``seq_gather``'s inverse for a whole sequence every rank holds: this
    rank's rows of dim ``dim`` (a view; its gradient is zero on the other
    rows)."""
    return _cut(x, dim, axes_size(mesh, seq_axes), axes_index(mesh, seq_axes))


def _permute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """The ``x`` of this rank's source under ``perm``, zeros where it has
    none: every rank's ``x`` all-gathered over the axis's group, the
    source's piece kept."""
    n = mesh.size(_dim(mesh, axis))
    sources, dests = [s for s, _ in perm], [d for _, d in perm]
    if len(set(sources)) < len(perm) or len(set(dests)) < len(perm) \
            or not all(0 <= i < n for i in sources + dests):
        raise ValueError(f"ppermute: {perm} is not a partial permutation of the {n} "
                         f"indices along {axis!r}")
    me = mesh.get_local_rank(axis)
    src = [s for s, d in perm if d == me]
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return parts[src[0]] if src else torch.zeros_like(x)


class _Permute(torch.autograd.Function):
    """``ppermute``; the backward hands each gradient back along the
    reversed pairs, as ``lax.ppermute``'s transpose does."""

    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, grad):
        back = tuple((d, s) for s, d in ctx.perm)
        return _permute(grad, ctx.mesh, ctx.axis, back), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """The counterpart of ``jax.lax.ppermute(x, axis, perm)``: ``perm``
    holds (source, destination) pairs of indices along ``axis``; each rank
    returns the ``x`` of the rank whose pair names it as destination, and
    zeros of ``x``'s shape and dtype where none does.  Written over an
    all-gather of ``x`` on the axis's group, of which each rank keeps its
    source's piece: gloo takes ``all_gather`` on CUDA tensors as on CPU
    ones, so one code path serves both.  Differentiable: the gradient goes
    back along the reversed pairs.  A ``perm`` that repeats a source or a
    destination, or names an index off the axis, is refused on every rank
    before any collective.  A collective: every rank of the axis's groups
    calls it, with the same ``perm``."""
    return _Permute.apply(x, mesh, axis, tuple((int(s), int(d)) for s, d in perm))


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
