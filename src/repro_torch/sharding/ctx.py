"""Global sharding context.

Port of ``repro.sharding.ctx``.  Model code is mesh-agnostic: it asks
``current()`` for the :class:`ShardingCtx` a launcher installed with
``use_sharding`` (thread-local, as in the reference), and reads its
options.  ``picnic_decode`` turns on the PICNIC distributed-scratchpad
decode (``models.attention.picnic_decode_attention``) over the mesh's
``seq_axes``.  ``dp_groups`` gives the process groups a data-parallel
train step reduces its batch statistics over.  ``shard_hint(x, role)``
marks activation boundaries as the reference's does, and returns ``x``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from .layout import axes_size
from .specs import dp_axes

_state = threading.local()


class ShardingCtx:
    def __init__(self, mesh, rules: Dict[str, object],
                 options: Optional[Dict[str, object]] = None):
        self.mesh = mesh            # a torch.distributed DeviceMesh with named dims
        self.rules = dict(rules)
        # feature flags consumed by model code:
        #   sp_attention : sequence-parallel attention for train/prefill
        #                  (not in the port yet)
        #   picnic_decode: partial-softmax decode over the sequence-sharded
        #                  KV cache (the PICNIC distributed scratchpad +
        #                  in-network reduction)
        #   seq_axes     : mesh axes carrying the sequence dim
        #   dp_axes      : mesh axes carrying the batch dim (by default
        #                  specs.dp_axes of the mesh)
        self.options = dict(options or {})

    def spec(self, role: str):
        return self.rules.get(role)

    def opt(self, name: str, default=None):
        return self.options.get(name, default)

    def dp_groups(self):
        """The process groups of the data-parallel axes of more than one
        rank, in order: the ranks whose batch shards make up one global
        batch."""
        axes = self.opt("dp_axes") or dp_axes(self.mesh)
        return tuple(self.mesh.get_group(a) for a in axes if axes_size(self.mesh, (a,)) > 1)


def current() -> Optional[ShardingCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def shard_hint(x, role: str):
    """The reference constrains ``x`` to the rule of ``role`` on the mesh
    (``with_sharding_constraint``).  The port runs one process a rank on
    plain local tensors: a rank's activations are its own batch shard
    already, so this returns ``x`` unchanged, with or without a context.
    (The sequence cut of ``act_btd`` over ``model`` comes with
    sequence-parallel attention; until then the ranks along ``model``
    compute the same batch shard.)"""
    return x
