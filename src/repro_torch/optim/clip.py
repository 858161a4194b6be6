"""Global-norm gradient clipping; port of ``repro.optim.clip``."""
import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in the JAX package's order."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn
