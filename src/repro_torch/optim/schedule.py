"""LR schedules (functions of the step); port of ``repro.optim.schedule``.
``step`` is a float32 tensor (a number is taken as one); the result is a
0-dim float32 tensor on its device, so nothing is read on the host."""
import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(step, *, base_lr, total_steps, final_frac=0.1):
    step = _f32(step)
    frac = torch.clamp(step / total_steps, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * (final_frac + (1 - final_frac) * cos)


def linear_warmup_cosine(step, *, base_lr, warmup_steps, total_steps,
                         final_frac=0.1):
    step = _f32(step)
    warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    post = cosine_schedule(torch.clamp(step - warmup_steps, min=0),
                           base_lr=base_lr,
                           total_steps=max(total_steps - warmup_steps, 1),
                           final_frac=final_frac)
    return torch.where(step < warmup_steps, warm, post)
