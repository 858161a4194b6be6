"""Where a rank sits on the mesh's axes, and its shard of a cache.

The reference lets ``shard_map`` cut a global array by a ``PartitionSpec``
and names a device's place with ``jax.lax.axis_index``; the port runs one
process a rank, and these functions give the same numbers from a
``DeviceMesh``: the size of a set of axes, the rank's index over them
(the last axis fastest, as ``picnic_decode_attention`` composes it), their
process groups, and ``local_cache``, the rank's shard of a global cache.
"""
from __future__ import annotations

from typing import Sequence

import torch


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


def local_cache(cache, mesh, *, seq_axes=("model",), dp_axes=("data",)):
    """This rank's shard of a global cache (as ``models.init_cache`` or a
    prefill returns it), as contiguous copies: every tensor's batch
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
