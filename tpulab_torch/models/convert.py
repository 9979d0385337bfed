"""The weight bridge: tpulab parameter trees -> the port's trees.

tpulab's ``init_*_params`` (or a checkpoint import) yields a pytree of JAX
arrays; ``np.asarray`` on each leaf gives the numpy tree this module
takes, with the same keys, shapes and layouts:

- transformer: ``embed``, ``final_norm``,
  ``layer{i}.{ln1,ln2,wqkv,wo,w1,w2,w3}``, ``lm_head`` (a weight-only
  quantized matrix is a ``{"w_int8", "scale"}`` sub-tree) —
  :func:`params_from_numpy` wraps it into a :class:`Transformer`;
- ResNet (HWIO conv kernels, folded-BN ``scale`` / ``bias``), ViT (either
  dialect, a LayerNorm's ``eps`` included) and MNIST — :func:`tree_from_numpy`
  gives the tree their ``*_apply`` functions and ``make_*(params=...)``
  take;
- MoE trees (``router`` (d, E), ``w1`` (E, d, f), ``w2`` (E, f, d), under
  ``layer{i}.moe`` in ``make_moe_transformer``'s) and stage trees stacked
  on dim 0 — :func:`tree_from_numpy` as they are.

Under a mesh, :func:`shard_from_numpy` gives each rank its shards of a
full tree under a placement tree, and :func:`gather_to_numpy` brings a
sharded tree back whole, so tests compare parameters after steps.

Nothing here imports JAX: the caller does the ``np.asarray`` on its side.
bf16 leaves arrive as numpy arrays of the ``bfloat16`` extension dtype;
their bits are carried over unchanged, as are int8 leaves'.  Python
scalars (a checkpoint's ``eps``) pass through as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tpulab_torch.models.transformer import Transformer


def tensor_from_numpy(arr, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device`` (bit-exact; bf16 leaves
    travel as their 16-bit patterns).  ``dtype`` recasts a floating leaf
    only: an int8 payload passes through untouched, as tpulab's own
    bf16 cast of a quantized tree leaves it."""
    arr = np.array(arr, copy=True, order="C")   # writable, contiguous
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def tree_from_numpy(tree: Dict[str, Any], device,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Map :func:`tensor_from_numpy` over a (nested dict) param tree;
    python scalars pass through."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_from_numpy(v, device, dtype)
        elif isinstance(v, (int, float)):
            out[k] = v
        else:
            out[k] = tensor_from_numpy(v, device, dtype)
    return out


def params_from_numpy(tree: Dict[str, Any], device, dtype=None, *,
                      n_heads: int, n_kv_heads: Optional[int] = None,
                      rope_theta: Optional[float] = None) -> Transformer:
    """tpulab's numpy param tree -> the port's :class:`Transformer` on
    ``device`` (``dtype`` optionally recasts every floating leaf)."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    return Transformer(tree_from_numpy(tree, dev, dtype), n_heads=n_heads,
                       n_kv_heads=n_kv_heads, rope_theta=rope_theta)


def shard_from_numpy(tree: Dict[str, Any], mesh, placements,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A full numpy tree -> this rank's DTensor shards under a matching
    tree of placements (from :mod:`tpulab_torch.parallel.sharding`), on
    the mesh's device; every rank passes the same full tree."""
    from tpulab_torch.parallel.sharding import shard_tree

    full = tree_from_numpy(tree, torch.device(mesh.device_type), dtype)
    return shard_tree(full, mesh, placements)


def gather_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A tree of DTensors (or tensors) -> whole numpy arrays, on every
    rank (every rank calls it: sharded leaves are all-gathered).  bf16
    leaves come back as float32, which holds every bf16 value exactly."""
    from tpulab_torch.parallel.sharding import full_tensor, map_tree

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        t = full_tensor(x).detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return map_tree(leaf, tree)
