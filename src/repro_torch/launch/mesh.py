"""Device meshes of the port over the default process group.

Translated from the reference's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` laid over the ranks of the
process group the caller initialised (``torch.distributed.
init_process_group``; ``launch.train`` does so from ``torchrun``'s
environment), rank ``r`` at row-major coordinate ``r``.  Single pod:
(data=16, model=16) = 256 ranks; multi-pod adds an outer "pod" axis (pure
data parallelism).
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.device import DeviceLike, resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None):
    """A mesh of ``shape`` named ``axes`` over the default process group,
    on ``device``'s type (None: CUDA, one card a rank).  The group must
    hold exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The reference's production mesh: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``.  The
    process group must hold 256 or 512 ranks; no smaller mesh is made in
    its place."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(f"the production mesh {shape} needs {n} ranks; "
                           f"this process group has {have}")
    return make_mesh(shape, axes, device)
