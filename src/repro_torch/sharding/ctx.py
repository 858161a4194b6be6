"""Global sharding context.

Port of ``repro.sharding.ctx``.  Model code is mesh-agnostic: it asks
``current()`` for the :class:`ShardingCtx` a launcher installed with
``use_sharding`` (thread-local, as in the reference), and reads its
options.  ``picnic_decode`` turns on the PICNIC distributed-scratchpad
decode (``models.attention.picnic_decode_attention``) over the mesh's
``seq_axes``, ``sp_attention`` the sequence cut of train and prefill
(``models.attention.sp_flash_attention``) over them.  ``dp_groups`` gives
the process groups a data-parallel train step reduces its batch
statistics over, ``sp_groups`` those of the sequence cut.
``shard_hint(x, role)`` marks activation boundaries as the reference's
does, and returns ``x``.
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
        #   sp_attention : sequence-parallel attention for train/prefill:
        #                  each rank holds its rows of the sequence (the
        #                  cut happens in models.forward)
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

    def sp_groups(self):
        """With ``sp_attention`` on, the process groups of the seq axes of
        more than one rank: the ranks whose rows make up one sequence, over
        which a sequence-parallel step reduces what the data-parallel axes
        reduce (whether a forward is cut also takes the sequence to divide,
        ``models.attention.sp_axes``)."""
        if not self.opt("sp_attention"):
            return ()
        axes = self.opt("seq_axes", ("model",))
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
    already, and under ``sp_attention`` its own rows of the sequence
    (``act_btd: P(dp, ("model",))``, cut by ``models.forward``; K/V, the
    mamba mixer's and the MoE dispatch's input gathered by
    ``sharding.seq_gather`` where the reference's rules replicate the
    sequence), so this returns ``x`` unchanged, with or without a
    context."""
    return x
