"""Multi-device dry run: ``python -m tpulab_torch.parallel.dryrun --nproc N
[--device cpu]`` (the counterpart of tpulab's
``__graft_entry__.dryrun_multichip``).

Spawns N ranks on this host (NCCL, one card each; gloo with
``--device cpu``) and runs tpulab's sequence on tiny shapes: one dp x tp
train step, the sharded forward (Megatron shards, this rank's vocab
columns), ring attention over ``sp`` (rope at global positions), the
expert-parallel MoE FFN over ``ep`` and the pipeline over ``pp``, each
checked in every rank against its single-device form (the train step:
its loss and every parameter against an unsharded autograd step).  tpulab routes to virtual CPU
devices when real ones are short; the port raises instead ("need N
devices"), so a missing card is never hidden.  tpulab's tail, paged
sharded decode (the batcher on ``{"model": 2}`` against ``mesh=None``,
greedy and device-sampled), closes the run.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from functools import partial

import numpy as np
import torch

VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF, SEQ = 128, 64, 4, 2, 128, 16
SERVE_D_MODEL, SERVE_HEADS = 128, 2     # the paged tail's model
ROPE = 10000.0
LR = 1e-2


def _check(label, got, want, tol=1e-4):
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"dryrun {label}: max abs err {err} > {tol}")
    return err


def _rank(rank: int, nproc: int, store: str, device) -> None:
    from tpulab_torch.engine.model import tree_leaves
    from tpulab_torch.models.transformer import (init_transformer_params,
                                                 transformer_apply)
    from tpulab_torch.parallel import multihost
    from tpulab_torch.parallel.mesh import (axis_index, make_mesh,
                                            mesh_device_type)
    from tpulab_torch.parallel.multihost import local_data_slice
    from tpulab_torch.parallel.moe import (init_moe_params,
                                           make_expert_parallel_ffn, moe_ffn)
    from tpulab_torch.parallel.pipeline import (make_pipeline,
                                                stack_stage_params)
    from tpulab_torch.parallel.ring_attention import ring_attention
    from tpulab_torch.parallel.sharding import full_tensor, map_tree
    from tpulab_torch.parallel.tensor_parallel import TensorParallel
    from tpulab_torch.parallel.training import (cross_entropy_loss,
                                                make_sharded_train_step,
                                                sgd_update_)

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", nproc, rank, device=device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh_device_type() == "cuda" else torch.device("cpu"))
    say = print if rank == 0 else (lambda *a, **k: None)
    f32 = torch.float32

    # dp x tp: half the ranks on each axis where the count is even
    n_model = 2 if nproc % 2 == 0 else 1
    n_data = nproc // n_model
    mesh = make_mesh({"data": n_data, "model": n_model})
    params = init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                     device=dev)
    apply_fn = partial(transformer_apply, n_heads=N_HEADS,
                       n_layers=N_LAYERS, compute_dtype=f32, rope_theta=ROPE)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, VOCAB, (2 * n_data, SEQ), generator=gen)
             for k in ("tokens", "targets")}
    step, sharded = make_sharded_train_step(apply_fn, params, mesh,
                                            learning_rate=LR)
    sharded, loss = step(sharded, batch)
    # the unsharded step on this rank alone: autograd over the whole
    # batch on a private copy, no collective
    ref = map_tree(lambda t: t.detach().clone().requires_grad_(True),
                   params)
    want = cross_entropy_loss(apply_fn, ref, {k: v.to(dev)
                                              for k, v in batch.items()})
    want.backward()
    with torch.no_grad():
        map_tree(lambda w: sgd_update_(w, w.grad, LR), ref)
    _check("train step loss", loss, want.detach())
    err = max(tree_leaves(map_tree(
        lambda d, w: _check("train step parameter", full_tensor(d),
                            w.detach()), sharded, ref)))
    say(f"dryrun train step ok on {nproc} devices (mesh data={n_data} "
        f"model={n_model}, {mesh_device_type()}): loss={float(loss):.4f}; "
        f"loss and every parameter against the unsharded step, max err "
        f"{err:.1e}", flush=True)

    # the sharded forward: this rank's rows through its Megatron shards
    lo, hi = local_data_slice(2 * n_data, mesh)
    rows = batch["tokens"][lo:hi].to(dev)
    with torch.no_grad():
        want = apply_fn(map_tree(full_tensor, sharded), {"tokens": rows}
                        )["logits"]
        kw = ({"tensor_parallel": TensorParallel(mesh)} if n_model > 1
              else {})
        out = apply_fn(map_tree(lambda d: d.to_local(), sharded),
                       {"tokens": rows}, **kw)["logits"]
        n = out.shape[-1]                  # this rank's vocab columns
        col = axis_index(mesh, "model")
        want = want[..., col * n:(col + 1) * n]
    err = _check("sharded forward", out, want)
    say(f"dryrun sharded inference ok: logits {tuple(out.shape)} per rank "
        f"(model={n_model}), max err {err:.1e} against the gathered "
        "weights", flush=True)

    # sequence parallelism: ring attention over an sp mesh
    sp_mesh = make_mesh({"sp": nproc})
    tokens = torch.randint(0, VOCAB, (1, 8 * nproc), generator=gen).to(dev)
    mine = tokens[:, 8 * rank:8 * (rank + 1)]
    with torch.no_grad():
        got = apply_fn(params, {"tokens": mine},
                       attention_fn=ring_attention(sp_mesh, "sp"))["logits"]
        want = apply_fn(params, {"tokens": tokens})["logits"][
            :, 8 * rank:8 * (rank + 1)]
    err = _check("ring attention", got, want)
    say(f"dryrun ring-attention (sp={nproc}) ok: logits {tuple(got.shape)} "
        f"per rank, max err {err:.1e} against one device", flush=True)

    # expert parallelism: experts sharded over an ep mesh
    ep_mesh = make_mesh({"ep": nproc})
    moe = init_moe_params(d_model=32, d_ff=64, n_experts=nproc, device=dev)
    ffn, shard_moe = make_expert_parallel_ffn(ep_mesh, axis_name="ep")
    x = torch.randn((8, 32), generator=gen).to(dev)
    got = ffn(shard_moe(moe), x)
    err = _check("expert-parallel MoE", got, moe_ffn(moe, x))
    say(f"dryrun expert-parallel MoE (ep={nproc}) ok: {tuple(got.shape)}, "
        f"max err {err:.1e} against the dense FFN", flush=True)

    # pipeline parallelism: GPipe microbatch streaming over a pp mesh
    pp_mesh = make_mesh({"pp": nproc})
    stages = [{"w": torch.eye(16, device=dev) * (1.0 + 0.5 * i)}
              for i in range(nproc)]
    pipeline, shard_pp = make_pipeline(pp_mesh, lambda p, x: x @ p["w"],
                                       axis_name="pp")
    x = torch.randn((4, 2, 16), generator=gen).to(dev)
    got = pipeline(shard_pp(stack_stage_params(stages)), x)
    want = x
    for p in stages:
        want = want @ p["w"]
    err = _check("pipeline", got, want)
    say(f"dryrun pipeline (pp={nproc}) ok: {tuple(got.shape)}, max err "
        f"{err:.1e} against the sequential stages", flush=True)

    # paged sharded decode: the serving path (ContinuousBatcher over a
    # pool sharded on KV heads, the ragged kernel on each rank's heads)
    # on {"model": 2} (a replica per pair of ranks) must emit the same
    # tokens as mesh=None, greedy and device-sampled (tpulab's tail)
    from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
    n_tp = 2 if nproc % 2 == 0 else 1
    serve_mesh = make_mesh({"data": nproc // n_tp, "model": n_tp})
    # head dim 64: the ragged kernel's smallest on the card
    lm = init_transformer_params(VOCAB, SERVE_D_MODEL, SERVE_HEADS, N_LAYERS,
                                 D_FF, device=dev)
    prompt = np.random.default_rng(0).integers(0, VOCAB, (6,), np.int32)
    paged = {}
    for name, m in (("single", None), ("sharded", serve_mesh)):
        if m is None and axis_index(serve_mesh, "model"):
            continue
        cb = ContinuousBatcher(lm, n_heads=SERVE_HEADS, n_layers=N_LAYERS,
                               lanes=2, max_len=48, page_size=8,
                               compute_dtype=f32, rope_theta=ROPE,
                               device=dev, mesh=m)
        try:
            if cb.is_coordinator:
                paged[name] = [
                    list(cb.submit(prompt, 12).result(timeout=600)),
                    list(cb.submit(prompt, 12, sampling=SamplingParams(
                        temperature=0.8, seed=7,
                        device=True)).result(timeout=600))]
        finally:
            cb.shutdown()
    if paged:
        if paged["sharded"] != paged["single"]:
            raise AssertionError(f"dryrun paged sharded decode diverged: "
                                 f"{paged}")
        say(f"dryrun paged sharded decode ok (mesh model={n_tp}): "
            f"parity=True, greedy and device-sampled, 12 tokens each",
            flush=True)


def main(argv=None) -> int:
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.parallel.multihost import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA cards (NCCL), one a rank")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    if device is None:
        resolve_device(None)
        have = torch.cuda.device_count()
        if args.nproc > have:
            raise RuntimeError(f"need {args.nproc} devices, have {have}")
    with tempfile.TemporaryDirectory() as d:
        launch(_rank, args.nproc, (args.nproc, os.path.join(d, "store"),
                                   device), timeout=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
