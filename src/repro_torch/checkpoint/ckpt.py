"""Checkpointing: atomic, manifest-driven save/restore of nested
dicts / tuples / lists of tensors, and recovery.  Port of
``repro.checkpoint.ckpt`` with the same on-disk format, so a checkpoint
written by one package restores in the other:

  <dir>/step_000123/
    manifest.json    — step, leaf names, shapes/dtypes, extras
    arrays.npz       — flat leaves a0, a1, ... (on the host); bfloat16 as
                       its uint16 bits, the reference's convention
    .complete        — commit marker written LAST (a crash mid-write
                       leaves no .complete and latest_step() ignores it)

The leaves are ordered and named as ``jax.tree_util`` orders and names
them (``keystr``): dict keys sorted, ``['key']`` for a dict key and
``[i]`` for a tuple or list index.  Nothing in the files needs more than
numpy and json to read.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

def _flatten_with_names(tree, prefix: str = "") -> Tuple[List[str], List[Any]]:
    """(names, leaves) in ``jax.tree_util.tree_flatten_with_path`` order."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    names, leaves = [], []
    for key, sub in items:
        n, lv = _flatten_with_names(sub, prefix + key)
        names += n
        leaves += lv
    return names, leaves


def _unflatten(tree_like, leaves):
    """``leaves`` (an iterator) into the nesting of ``tree_like``."""
    if isinstance(tree_like, dict):       # leaves in sorted key order, keys in the like's
        vals = {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
        return {k: vals[k] for k in tree_like}
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor leaf as the array stored in arrays.npz and its dtype's name."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:           # npz has no bfloat16: keep the bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extras: Optional[Dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names, leaves = _flatten_with_names(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        a, dt = _to_numpy(leaf)
        arrays[f"a{i}"] = a
        dtypes.append(dt)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "names": names,
        "shapes": [list(np.shape(a)) for a in arrays.values()],
        "dtypes": dtypes,
        "extras": extras or {},
        "time": time.time(),
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    (tmp / ".complete").touch()
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best = None
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / ".complete").exists():
            s = int(p.name.split("_")[1])
            best = s if best is None else max(best, s)
    return best


def restore(ckpt_dir: str | Path, tree_like: Any,
            step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (tensor leaves): each
    leaf a tensor of the like leaf's shape (checked), dtype (cast) and
    device."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    names, like_leaves = _flatten_with_names(tree_like)
    if names != manifest["names"]:
        raise ValueError("checkpoint tree structure mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    out = []
    with np.load(d / "arrays.npz", allow_pickle=False) as data:
        for i, (name, like) in enumerate(zip(names, like_leaves)):
            t = _from_numpy(data[f"a{i}"], manifest["dtypes"][i])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {name} has shape {tuple(t.shape)}, "
                                 f"the target {tuple(like.shape)}")
            out.append(t.to(device=like.device, dtype=like.dtype))
    return _unflatten(tree_like, iter(out)), manifest["extras"]


def gc_old(ckpt_dir: str | Path, keep: int = 3):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_")
                   and (p / ".complete").exists())
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree.detach().to("cpu", copy=True)


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in-flight write;
    back-pressure if the previous write hasn't finished)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extras: Optional[Dict] = None):
        self.wait()
        # device->host copy happens synchronously (consistent snapshot);
        # disk IO happens on the thread.
        host_tree = _host_copy(tree)

        def work():
            save(self.ckpt_dir, step, host_tree, extras)
            gc_old(self.ckpt_dir, self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
