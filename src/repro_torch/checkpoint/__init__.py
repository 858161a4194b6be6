from .ckpt import AsyncCheckpointer, gc_old, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "gc_old", "latest_step", "restore", "save"]
