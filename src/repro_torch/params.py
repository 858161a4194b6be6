"""Parameters from the JAX package: ``from_jax`` turns a JAX parameter
pytree, given as numpy arrays (``jax.tree.map(np.asarray, params)``), into
the port's tensors with the same nesting and the stacked layer axis.  This
is how the parity tests give both packages the same weights."""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: via float32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def from_jax(tree, device):
    """Nested dicts of arrays -> nested dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)
