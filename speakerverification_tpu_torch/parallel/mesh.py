"""The device mesh (port of ``parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over the devices that one
process drives. The port runs one process per GPU, so its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group: the first axis is the data axis, a second (minor) axis
the model axis of the class-sharded head, so that the ranks of one model
group are consecutive, as the JAX mesh keeps a model row inside a host.
``mesh.get_group(axis)`` is the process group of this rank's row or
column along ``axis``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["make_mesh", "world_size"]


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(axes: Tuple[str, ...] = ("data",),
              shape: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` over every rank (default: all ranks
    on the first axis), of ``cuda`` under NCCL and ``cpu`` otherwise
    (gloo stages CUDA tensors through the host)."""
    world = world_size()
    if shape is None:
        shape = [world] + [1] * (len(axes) - 1)
    shape = [int(s) for s in shape]
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.maybe_initialize_distributed)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda" if dist.get_backend() == "nccl"
                            else "cpu", tuple(shape),
                            mesh_dim_names=tuple(axes))
