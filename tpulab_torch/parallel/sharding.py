"""Placements + transformer partition rules (the port of
``tpulab/parallel/sharding.py``).

tpulab annotates arrays with ``NamedSharding(mesh, PartitionSpec)`` and
lets XLA insert the collectives.  The port's counterpart of a spec is a
DTensor placement tuple, one :class:`Shard` / :class:`Replicate` per mesh
axis: :func:`named_sharding` maps a PartitionSpec-like tuple (one entry
per tensor dim: ``None``, an axis name, or a tuple of axis names in mesh
order) onto it, so tpulab's rules and the port's are compared leaf for
leaf.  A sharded tensor is a :class:`DTensor` whose local shard each rank
cuts from the full tensor itself (:func:`shard_tensor`: no collective,
DTensor's chunking, uneven shards included).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

Placements = Tuple[Any, ...]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (and over the matching
    leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def named_sharding(mesh, *spec) -> Placements:
    """tpulab's ``NamedSharding(mesh, P(*spec))`` as placements."""
    names = tuple(mesh.mesh_dim_names or ())
    placements = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} not in mesh axes {names}")
            if a in seen:
                raise ValueError(f"axis {a!r} shards two dims of {spec}")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise NotImplementedError(
                f"dim {dim} sharded over {axes}: DTensor shards one dim "
                "over several axes in mesh order only")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


def replicate(mesh) -> Placements:
    return named_sharding(mesh)


def shard_batch(mesh, axis: str = "data") -> Placements:
    """Batch-dim sharding for activations / inputs (DP)."""
    return named_sharding(mesh, axis)


def kv_pool_sharding(mesh, model_axis: str = "model") -> Placements:
    """The paged pool's fused ``(n_layers, n_pages, 2, page_size,
    n_kv_heads, head_dim)`` payloads shard on the KV-heads dim (4),
    matching the column-parallel ``wqkv`` that writes them:
    ``PagedKVPool(mesh=)`` keeps rank r's heads ``[r*Hkv/M, (r+1)*Hkv/M)``
    as a plain local tensor and reports these placements as its
    ``kv_sharding``."""
    return named_sharding(mesh, None, None, None, None, model_axis, None)


def _param_spec(path: str, model_axis: str):
    """tpulab's Megatron rule for one parameter path, as a spec tuple:
    ``wqkv`` / ``w1`` / ``w3`` / ``lm_head`` column-parallel, ``wo`` /
    ``w2`` row-parallel, ``embed`` on the vocab dim, the rest
    replicated."""
    if path.endswith(("wqkv", "w1", "w3", "lm_head")):
        return (None, model_axis)
    if path.endswith(("wo", "w2", "embed")):
        return (model_axis, None)
    return ()


def transformer_param_shardings(params: Dict[str, Any], mesh,
                                model_axis: str = "model") -> Dict[str, Any]:
    """The placement tree of a transformer param tree (tpulab's rules,
    the tree's nesting kept leaf for leaf)."""
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}") for k, v in tree.items()}
        return named_sharding(mesh, *_param_spec(prefix, model_axis))
    return build(params)


def _chunk(n: int, parts: int, i: int) -> Tuple[int, int]:
    """DTensor's ``Shard`` chunk ``i`` of ``n`` rows over ``parts``:
    ceil-sized chunks, the last ones short or empty."""
    size = -(-n // parts)
    start = min(i * size, n)
    return start, min(start + size, n)


def local_slice(full: torch.Tensor, mesh, placements: Placements
                ) -> torch.Tensor:
    """This rank's view of ``full`` under ``placements`` (mesh axes in
    order: a dim sharded over two axes is cut by the first, then the
    piece by the second)."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            lo, hi = _chunk(out.shape[p.dim], mesh.size(i), coord[i])
            out = out.narrow(p.dim, lo, hi - lo)
    return out


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def shard_tensor(full: torch.Tensor, mesh, placements: Placements
                 ) -> DTensor:
    """A DTensor laid out by ``placements`` whose local shard is a copy of
    this rank's slice of ``full`` (every rank holds ``full``; no
    collective runs, and the caller's tensor is never aliased)."""
    local = local_slice(full, mesh, placements).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape,
                              stride=_contiguous_strides(full.shape))


def shard_tree(tree, mesh, placements_tree):
    """:func:`shard_tensor` over a tree; non-tensor leaves pass through."""
    return map_tree(lambda x, p: shard_tensor(x, mesh, p)
                    if isinstance(x, torch.Tensor) else x,
                    tree, placements_tree)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a DTensor: its local shard itself where no
    axis of more than one rank shards it (no copy), else an all-gather.
    A plain tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if all(isinstance(p, Replicate) or mesh.size(i) == 1
           for i, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()
