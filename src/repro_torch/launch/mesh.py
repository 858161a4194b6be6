"""Production mesh builders: ``torch.distributed.device_mesh`` meshes.

Port of ``repro.launch.mesh``.  Both builders are FUNCTIONS (not
module-level constants), so importing this module touches no process
group.  They run over the process group the launcher has already
initialised (``torch.distributed.init_process_group``, or the default
group ``init_device_mesh`` makes from the environment).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

POD_SHAPE = (16, 16)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 ranks a pod ``("data", "model")``; 2 pods when multi_pod
    (512 ranks, ``("pod", "data", "model")``), of ``device_type`` (the
    dry run's is ``"cpu"``, over a fake process group).  Raises
    ``ValueError`` when the world holds another number of ranks."""
    shape = (2, *POD_SHAPE) if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1
    for n in shape:
        need *= n
    if world != need:
        raise ValueError(f"the production mesh {shape} {axes} needs {need} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """Every rank of the initialised process group as a ``(world, 1)``
    ``("data", "model")`` mesh: what smoke tests and examples run on (one
    rank gives a 1 x 1 mesh)."""
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
