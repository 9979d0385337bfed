"""Pipeline parallelism: GPipe microbatch streaming (the port of
``tpulab/parallel/pipeline.py``).

Stages partition layers across a mesh axis; at step t, stage s computes
microbatch t - s and hands its activation to stage s + 1.  The schedule
runs ``n_stages + n_micro - 1`` steps (the bubble), as tpulab's.  tpulab
keeps one static program for every device and masks bubble steps out;
each rank here knows its step and stage on the host, so a bubble step
computes nothing and passes its input through.  The hand-off is one
``batch_isend_irecv`` to the next stage (never to oneself: with one stage
it is the identity); the last stage collects the finished microbatches,
and an ``all_reduce`` over the axis replicates them to every stage.

The stage body must be shape-preserving ((mb, d) -> (mb, d)).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from tpulab_torch.parallel.mesh import axis_group, axis_index, axis_size
from tpulab_torch.parallel.sharding import (map_tree, named_sharding,
                                            shard_tensor)


def make_pipeline(mesh, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  axis_name: str = "pp"):
    """Build ``(pipeline_fn, shard_params_fn)``.

    ``shard_params_fn(stacked_params)`` shards a tree whose leaves are
    stacked on dim 0 by stage ((n_stages, ...)), one stage per rank;
    ``pipeline_fn(params, x)`` takes the microbatched input
    (n_micro, mb, d), the same on every rank, and returns (n_micro, mb,
    d) on every rank."""
    n_stages = axis_size(mesh, axis_name)
    sub = mesh[axis_name]
    spec = named_sharding(sub, axis_name)
    group = axis_group(mesh, axis_name)

    def shard_params(stacked_params):
        def leaf(x):
            if x.shape[0] != n_stages:
                raise ValueError(
                    f"stacked stage dim {x.shape[0]} != pipeline axis "
                    f"{axis_name}={n_stages} (one stage per device)")
            return shard_tensor(x, sub, spec)
        return map_tree(leaf, stacked_params)

    def pipeline(sharded_params, x):
        params_me = map_tree(lambda p: p.to_local()[0], sharded_params)
        s = axis_index(mesh, axis_name)
        n_micro = x.shape[0]
        collected = torch.zeros_like(x)
        state = torch.zeros_like(x[0])
        for t in range(n_stages + n_micro - 1):
            m = t - s                      # my microbatch this step
            inp = x[min(t, n_micro - 1)] if s == 0 else state
            out = stage_fn(params_me, inp) if 0 <= m < n_micro else inp
            if 0 <= m < n_micro and s == n_stages - 1:
                collected[m] = out
            state = _hand_off(out, group, s, n_stages)
        if s != n_stages - 1:
            collected.zero_()
        dist.all_reduce(collected, group=group)
        return collected

    return pipeline, shard_params


def _hand_off(out, group, s: int, n: int):
    """Send ``out`` to stage s + 1, receive stage s - 1's (zeros at stage
    0, as ``ppermute`` leaves a device no pair sends to)."""
    ops = []
    recv = torch.zeros_like(out)
    if s + 1 < n:
        ops.append(dist.P2POp(dist.isend, out.contiguous(),
                              dist.get_global_rank(group, s + 1), group))
    if s > 0:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, s - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def stack_stage_params(per_stage_params) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with leaves stacked on
    dim 0 (the layout ``shard_params_fn`` expects)."""
    return map_tree(lambda *xs: torch.stack(xs), *per_stage_params)
