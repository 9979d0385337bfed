"""Device meshes over ``torch.distributed`` ranks (the port of
``tpulab/parallel/mesh.py``).

A tpulab mesh is a grid of the devices one JAX program sees.  The port's
is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, one rank per device: one process per card
under NCCL, CPU ranks under gloo.  Axis names and their order are
tpulab's: ``data`` (DP) outermost, ``model`` (TP) innermost.

Per-rank bodies (ring and Ulysses attention, expert and pipeline
parallelism) speak to one mesh axis through :func:`axis_group`,
:func:`axis_index` and :func:`axis_size`, the counterparts of the axis
name a ``shard_map`` body hands to ``psum`` / ``axis_index``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_device_type() -> str:
    """Where the default group's collectives run: the device type
    :func:`~tpulab_torch.parallel.multihost.initialize` chose (``"cuda"``
    under NCCL or gloo's CUDA collectives, ``"cpu"`` under gloo on the
    CPU); for a group opened elsewhere, ``"cuda"`` under NCCL, else
    ``"cpu"``."""
    from tpulab_torch.parallel import multihost

    return multihost.device_type() or (
        "cuda" if dist.get_backend() == "nccl" else "cpu")


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None
              ) -> DeviceMesh:
    """A mesh with the given axis sizes, e.g. ``{"data": 2, "model": 4}``.

    ``devices`` lists the global ranks to lay out (default: every rank of
    the default group, which :func:`~tpulab_torch.parallel.multihost.
    initialize` opens if it is not open).  The dict's order is the grid
    order: later axes are innermost.  Every rank of the group calls this
    together (the axes' groups are created collectively)."""
    from tpulab_torch.parallel import multihost

    multihost.initialize()
    ranks = (list(devices) if devices is not None
             else list(range(dist.get_world_size())))
    total = math.prod(axes.values())
    if total > len(ranks):
        raise ValueError(f"mesh needs {total} devices, have {len(ranks)}")
    grid = torch.tensor(ranks[:total], dtype=torch.int64).reshape(
        tuple(axes.values()))
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=tuple(axes))


def default_mesh(n_model: int = 1, devices: Optional[Sequence[int]] = None
                 ) -> DeviceMesh:
    """Every rank: data-parallel outer, model-parallel inner."""
    from tpulab_torch.parallel import multihost

    multihost.initialize()
    ranks = (list(devices) if devices is not None
             else list(range(dist.get_world_size())))
    n = len(ranks)
    if n % n_model:
        raise ValueError(f"{n} devices not divisible by model={n_model}")
    return make_mesh({"data": n // n_model, "model": n_model}, ranks)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis: size}`` in grid order (tpulab's ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    return names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(_dim(mesh, axis))
