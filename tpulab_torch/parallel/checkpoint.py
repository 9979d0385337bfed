"""Distributed train-state checkpoint / resume on
``torch.distributed.checkpoint`` (DCP) — the port of
``tpulab/parallel/checkpoint.py``, which uses orbax.

One directory per step under the checkpointer's directory, holding DCP's
files: each rank writes the shards it owns, and the coordinator's
``.metadata`` (written last) marks the step finished.  Restore takes a
target tree whose leaves say where each tensor lands (a DTensor's mesh
and placements, a plain tensor's device) and DCP moves the saved bytes to
that layout, so a state saved on one mesh restores onto another.
Non-tensor leaves (a ``"step"`` int) round-trip as they are.  Retention
deletes the oldest finished steps beyond ``max_to_keep``.  The orbax
format is not carried (ROADMAP decisions: DCP instead of orbax).

With a process group open, the checkpointer runs DCP's coordination on a
gloo group of its own (every rank constructs it together), so an
asynchronous save finishes on a host thread whatever the default
backend.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor

from tpulab_torch.parallel.sharding import local_slice, map_tree

__all__ = ["TrainCheckpointer", "abstract_like"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Where a restored tensor lands (``jax.ShapeDtypeStruct`` with a
    sharding): global shape, dtype, and a mesh and placements (a DTensor)
    or a device (a plain tensor)."""

    shape: tuple
    dtype: torch.dtype
    mesh: Any = None
    placements: Optional[tuple] = None
    device: Optional[torch.device] = None

    def allocate(self):
        if self.mesh is None:
            return torch.empty(self.shape, dtype=self.dtype,
                               device=self.device)
        full = torch.empty(self.shape, dtype=self.dtype, device="meta")
        local = torch.empty_like(local_slice(full, self.mesh,
                                             self.placements),
                                 device=self.mesh.device_type,
                                 memory_format=torch.contiguous_format)
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=full.shape,
                                  stride=full.stride())


def abstract_like(tree: Any, shardings=None, mesh=None) -> Any:
    """The restore target of a concrete (or abstract) tree: a
    :class:`TensorSpec` per tensor leaf.  With ``shardings`` (a matching
    tree of placements, e.g. from ``transformer_param_shardings``) and
    ``mesh``, every leaf lands in that layout: pass the NEW mesh's to
    reshape a checkpoint across topologies.  Without them each leaf keeps
    the layout it has (a numpy leaf: a plain CPU tensor).  Non-tensor
    leaves pass through."""
    def leaf(x, s=None):
        if isinstance(x, TensorSpec) and s is None:
            return x
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, (torch.Tensor, TensorSpec)):
            return x
        shape = tuple(x.shape)
        if s is not None:
            if mesh is None:
                raise ValueError("shardings need the mesh they lay out on")
            return TensorSpec(shape, x.dtype, mesh, tuple(s))
        if isinstance(x, DTensor):
            return TensorSpec(shape, x.dtype, x.device_mesh,
                              tuple(x.placements))
        return TensorSpec(shape, x.dtype, device=x.device)

    if shardings is not None:
        return map_tree(leaf, tree, shardings)
    return map_tree(leaf, tree)


class TrainCheckpointer:
    """Step-numbered sharded checkpoints with retention + resume-latest.

    ``save(step, state)`` -> an asynchronous write (state staged to host
    memory before it returns); ``restore(target, step=None)`` -> the state
    in the target's layout; ``latest_step()`` -> the newest finished step
    (``None`` on a fresh directory)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        self._pending = None
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized() else None)
        os.makedirs(self._dir, exist_ok=True)

    def _kw(self):
        return dict(process_group=self._group,
                    no_dist=self._group is None)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write ``state`` (a tree of tensors, DTensors and plain values)
        as checkpoint ``step``.  Asynchronous by default: the state is
        staged to host memory before this returns, so the caller may
        update it in place at once; ``wait=True`` (or :meth:`wait`)
        blocks until the step is on disk."""
        self.wait()
        if wait:
            dcp.save(state, checkpoint_id=self._path(step), **self._kw())
            self._retain()
            return
        # DCP's default stager copies the state to host memory before
        # async_save returns; the upload's Future is what remains
        self._pending = dcp.async_save(state, checkpoint_id=self._path(step),
                                       **self._kw())

    def wait(self) -> None:
        """Block until the pending save is on disk, then apply retention."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
            self._retain()

    def _retain(self) -> None:
        if self._keep is not None and (self._group is None
                                       or dist.get_rank(self._group) == 0):
            for step in self.all_steps()[:-self._keep]:
                shutil.rmtree(self._path(step), ignore_errors=True)
        if self._group is not None:
            dist.barrier(group=self._group)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """Finished steps (their ``.metadata`` written), ascending."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self._dir, n, ".metadata")))

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Checkpoint ``step`` (default: the latest) in ``target``'s
        layout: a tree of tensors, DTensors or :class:`TensorSpec` s from
        :func:`abstract_like` (build it with the new mesh's placements to
        reshape across topologies).  Returns a new tree; ``target`` is
        left as it is."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        state = map_tree(lambda x: x.allocate()
                         if isinstance(x, TensorSpec) else x,
                         abstract_like(target))
        dcp.load(state, checkpoint_id=self._path(step), **self._kw())
        return state

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
