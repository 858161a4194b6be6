"""Optimizers, gradient clipping and LR schedules: port of ``repro.optim``.

Params, gradients and optimizer state are nested dicts of tensors (the
JAX package's pytrees); a state keeps the JAX keys, with a 0-dim int32
``step`` tensor on the parameters' device.  Updates are functions that
return new tensors, as the JAX ones return new arrays, or with
``donate=True`` write the same bits into the given params and state (the
captured train step's form), and read nothing on the host: ``lr`` and the
step stay tensors."""
from .adamw import adamw_init, adamw_update
from .adafactor import adafactor_init, adafactor_update
from .schedule import cosine_schedule, linear_warmup_cosine
from .clip import global_norm, clip_by_global_norm

__all__ = ["adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
           "cosine_schedule", "linear_warmup_cosine", "global_norm",
           "clip_by_global_norm", "make_optimizer"]


def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
