"""Production and host meshes (port of ``repro.launch.mesh``) as
``torch.distributed`` ``DeviceMesh``es.

Each is built by a FUNCTION over a process group the caller has
initialised (``torch.distributed.init_process_group`` with its address,
world size and rank), never at import.  The production meshes want a
group of their size: 256 ranks (16 x 16, ``("data", "model")``) or 512
(2 x 16 x 16, ``("pod", "data", "model")``); the host mesh is 1-d
(``("data",)``) over every rank of the group, one device a rank.
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_host_mesh"]


def _world(device_type: str) -> int:
    import torch
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("initialise a torch.distributed process group "
                           "before building a mesh")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a CPU mesh")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 x 16 x 16 = 512 over two pods."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world(device_type)
    if n != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a "
                         f"process group of that size, not {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """The group's ranks as a 1-d ``("data",)`` mesh, one device a
    rank."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (_world(device_type),),
                            mesh_dim_names=("data",))
