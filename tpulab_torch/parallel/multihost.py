"""Process-group bootstrap and topology helpers (the port of
``tpulab/parallel/multihost.py``).

tpulab bootstraps ``jax.distributed``: one process per host, each seeing
its local chips.  The port opens a ``torch.distributed`` default group:
one rank per device, so a "process" here is a rank.

- :func:`initialize` — ``init_process_group`` from tpulab's arguments
  (``coordinator_address`` ``"host:port"`` -> a ``TCPStore`` served by
  rank 0, or ``"file://<path>"`` -> a ``FileStore``), else from
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, else a
  group of one over an in-memory store.  NCCL on the card (the
  default); gloo only when the caller passes ``device="cpu"``, or asks
  for it by name (``backend="gloo"``: its CUDA collectives).  Every
  collective times out (``TIMEOUT_S``).
- :func:`global_mesh` — every rank, data outermost, model inner.
- :func:`barrier` — tpulab's psum barrier: ones all-reduced over the mesh.
- :func:`local_data_slice` — the rows of a global batch this rank feeds.
- :func:`launch` — start N ranks of a function on this host (spawned
  processes, each joined under one deadline).
"""

from __future__ import annotations

import datetime
import os
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _backend(device) -> str:
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {dev}")


def _store(coordinator_address: str, world: int, rank: int):
    if coordinator_address.startswith("file://"):
        return dist.FileStore(coordinator_address[len("file://"):], world)
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address {coordinator_address!r}: "
                         "want 'host:port' or 'file://<path>'")
    return dist.TCPStore(host, int(port), world, is_master=rank == 0)


#: seconds a collective may wait for its partners before it raises (a
#: lost rank ends in an error, not a hang)
TIMEOUT_S = 600.0
_device_type: Optional[str] = None


def device_type() -> Optional[str]:
    """Where the default group's ranks keep their tensors (``"cuda"`` or
    ``"cpu"``), as :func:`initialize` chose it; None when another caller
    opened the group."""
    return _device_type


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> None:
    """Open the default process group; a no-op once it is open.

    ``device=None`` means the CUDA card (NCCL; raises without one) and
    sets this rank's current CUDA device to ``process_id`` modulo the
    cards visible; ``device="cpu"`` takes gloo.  ``backend="gloo"`` on
    the card asks for gloo's CUDA collectives by name (ranks sharing one
    card, which NCCL refuses).  Every collective raises after
    :data:`TIMEOUT_S`.
    With no arguments and no ``RANK`` / ``WORLD_SIZE`` in the environment
    the group holds this process alone."""
    global _device_type
    if dist.is_initialized():
        return
    from tpulab_torch.cuda.platform import resolve_device

    dev_type = resolve_device(device).type
    if backend is None:
        backend = _backend(device)
    elif backend not in ("nccl", "gloo") or (backend == "nccl"
                                             and dev_type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev_type}")
    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id go together")
        world, rank = int(num_processes), int(process_id)
        store = _store(coordinator_address, world, rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        store = _store(f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}", world, rank)
    else:
        world, rank, store = 1, 0, dist.HashStore()
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device_type = dev_type


def global_mesh(n_model: int = 1, extra_axes: Optional[Dict[str, int]] = None):
    """Mesh over every rank of the job: data (outermost) x model
    [+ extra inner axes]."""
    from tpulab_torch.parallel.mesh import make_mesh

    initialize()
    n = dist.get_world_size()
    inner = {"model": n_model, **(extra_axes or {})}
    inner_total = 1
    for v in inner.values():
        inner_total *= v
    if n % inner_total:
        raise ValueError(f"{n} devices not divisible by inner axes {inner}")
    return make_mesh({"data": n // inner_total, **inner})


def barrier(mesh=None) -> None:
    """Returns when every rank of ``mesh`` reached it: ones all-reduced
    along each axis in turn must sum to the mesh's size."""
    from tpulab_torch.parallel.mesh import mesh_device_type

    if mesh is None:
        mesh = global_mesh()
    total = torch.ones((1,), dtype=torch.int32, device=mesh_device_type())
    for dim in range(mesh.ndim):
        dist.all_reduce(total, group=mesh.get_group(dim))
    if int(total.item()) != mesh.size():
        raise RuntimeError(f"barrier counted {int(total.item())} of "
                           f"{mesh.size()} ranks")


def supports_multiprocess_collectives(mesh=None) -> bool:
    """Can this backend run a collective across processes?  NCCL and gloo
    both can (tpulab's CPU backend cannot), so this runs a real barrier
    and returns True; a failing collective raises."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        barrier(mesh)
    return True


def local_data_slice(global_batch: int, mesh=None) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this rank feeds: rows map
    contiguously to the mesh's ``data`` coordinate (to the rank when the
    mesh is ``None`` or has no ``data`` axis), remainder rows to the
    first ranks — every row is owned."""
    from tpulab_torch.parallel.mesh import axis_index, axis_size

    if mesh is not None and "data" in (mesh.mesh_dim_names or ()):
        n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    per, rem = divmod(global_batch, n)
    start = i * per + min(i, rem)
    return start, start + per + (1 if i < rem else 0)


def _rank_main(fn, rank, args):
    try:
        fn(rank, *args)
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, nproc: int, args: Sequence = (),
           timeout: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``nproc`` spawned processes (``fn``
    importable by name; each rank opens its own group, e.g. through
    :func:`initialize` over a ``file://`` store).  Raises when a rank
    fails or the ranks are not all done within ``timeout`` seconds, and
    leaves no process behind."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, tuple(args)),
                         daemon=True) for r in range(nproc)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {nproc} still running "
                               f"after {timeout:g} s")
        failed = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
