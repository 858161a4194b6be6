"""Fake-tensor stand-ins for every step input (no device allocation).

Port of ``repro.launch.input_specs``: the same inputs as ``FakeTensor``s
of one shared ``FakeTensorMode`` (``fake_mode()``) instead of
``ShapeDtypeStruct``s, for the dry run (``launch.dryrun``) to run the
port's own step functions on:
  train   -> batch {tokens, labels [, prefix_embeds | encoder_embeds]}
  prefill -> batch {tokens [, ...stubs]}
  decode  -> (token, cache, cache_len)
Modality frontends are STUBS, as in the reference: the vlm/audio entries
get precomputed patch/frame embeddings.  ``cache_len`` is the int
``seq_len`` (the cache full, as the reference's ``model_flops`` counts
its decode), where the reference passes a traced int32 scalar.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs import ShapeSpec
from repro_torch.models.common import dtype_of

_MODE = None


def fake_mode():
    """The one ``FakeTensorMode`` these stand-ins are made in (tensors of
    two modes do not mix)."""
    global _MODE
    if _MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


def _stub_inputs(cfg, batch: int):
    extra = {}
    with fake_mode():
        if cfg.n_prefix_tokens:
            extra["prefix_embeds"] = torch.empty((batch, cfg.n_prefix_tokens, cfg.d_model),
                                                 dtype=dtype_of(cfg))
        if cfg.is_encoder_decoder:
            extra["encoder_embeds"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                                                  dtype=dtype_of(cfg))
    return extra


def train_batch_specs(cfg, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    with fake_mode():
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32),
                 "labels": torch.empty((B, S), dtype=torch.int32)}
    batch.update(_stub_inputs(cfg, B))
    return batch


def prefill_batch_specs(cfg, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    with fake_mode():
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32)}
    batch.update(_stub_inputs(cfg, B))
    return batch


def decode_arg_specs(cfg, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    with fake_mode():
        cache = models.init_cache(cfg, B, S)
        token = torch.empty((B, 1), dtype=torch.int32)
    return token, cache, S


def params_shapes(cfg):
    with fake_mode():
        return models.init_params(cfg, torch.Generator())
