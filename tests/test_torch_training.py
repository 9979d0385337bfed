"""The port's sharded train step and checkpoints against tpulab's, on the
CPU.

tpulab's ``make_sharded_train_step`` runs on its 8-virtual-device CPU
mesh; the port's runs in spawned gloo ranks (world sizes 1, 2 and 4:
``{"data": 1, "model": 1}``, ``{"data": 2, "model": 1}`` and
``{"data": 2, "model": 2}``), each launch joined within 120 s.  Both start
from tpulab's weights (a 2-layer GQA SwiGLU model with an untied head
and rope, so every Megatron rule shards something) and take 3 SGD steps
on one numpy batch; the per-step losses and the final parameters,
gathered whole, must agree at f32 within rtol 1e-5 / atol 1e-6 (two
backends, two summation orders).  Over the 2 x 2 mesh the model axis
splits the step's compute (Megatron's column / row products, tensor
parallelism's collectives on gloo): a rank runs half the FLOPs of a
data-only rank.  The bf16 update rounds as tpulab's bit
for bit; the flash ``attention_fn`` (its plain version and the blockwise
backward on CPU tensors) trains as dense attention does; a resumed run
equals the uninterrupted one bit for bit, retention keeps the newest
steps, and a checkpoint saved under one mesh restores onto another.
"""

import functools
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.models.transformer import init_transformer_params as jax_init
from tpulab.models.transformer import transformer_apply as jax_apply
from tpulab.parallel import make_mesh as jax_make_mesh
from tpulab.parallel.training import make_sharded_train_step as jax_step
import tpulab_torch.parallel as tp
from tpulab_torch.models.convert import gather_to_numpy, shard_from_numpy
from tpulab_torch.models.transformer import causal_attention, transformer_apply
from tpulab_torch.ops.flash_attention import make_flash_attention_fn
from tpulab_torch.parallel import multihost
from tpulab_torch.parallel.training import (cross_entropy_loss,
                                            make_sharded_train_step,
                                            sgd_update_)

torch.set_num_threads(2)

MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
KV, ROPE, LR, STEPS = 2, 10000.0, 5e-2, 3
B, T = 4, 8
RTOL, ATOL = 1e-5, 1e-6
MESHES = {1: {"data": 1, "model": 1}, 2: {"data": 2, "model": 1},
          4: {"data": 2, "model": 2}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return out


def _jax_params():
    return jax_init(MODEL["vocab"], MODEL["d_model"], MODEL["n_heads"],
                    MODEL["n_layers"], MODEL["d_ff"], seed=0, n_kv_heads=KV,
                    ffn="swiglu", tie_embeddings=False)


def _batch(rows=B):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, MODEL["vocab"], (rows, T), np.int32)
            for k in ("tokens", "targets")}


@functools.lru_cache(maxsize=None)
def _jax_run(axes, rows=B):
    """tpulab's step on its CPU mesh (``axes``: the mesh's items):
    per-step losses, final params."""
    apply_fn = partial(jax_apply, n_heads=MODEL["n_heads"],
                       n_layers=MODEL["n_layers"], compute_dtype=jnp.float32,
                       n_kv_heads=KV, rope_theta=ROPE)
    step, p = jax_step(apply_fn, _jax_params(), jax_make_mesh(dict(axes)),
                       learning_rate=LR)
    batch = _batch(rows)
    losses = []
    for _ in range(STEPS):
        p, loss = step(p, batch)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in _flat(p).items()}


def _axes(world):
    return tuple(MESHES[world].items())


def _apply(attention_fn=causal_attention):
    return partial(transformer_apply, n_heads=MODEL["n_heads"],
                   n_layers=MODEL["n_layers"], compute_dtype=torch.float32,
                   n_kv_heads=KV, rope_theta=ROPE, attention_fn=attention_fn)


def _train(params, mesh, batch, attention_fn=causal_attention, steps=STEPS,
           ckpt=None, save_at=None, wait=True):
    step, sp = make_sharded_train_step(_apply(attention_fn), params, mesh,
                                       learning_rate=LR)
    losses = []
    for i in range(steps):
        sp, loss = step(sp, batch)
        losses.append(float(loss))
        if ckpt is not None and i == save_at:
            ckpt.save(i, {"step": i, "params": sp}, wait=wait)
    return losses, sp


# ------------------------------------------------------------ rank bodies
def _rank_train(rank, world, store, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    flat = dict(np.load(os.path.join(out_dir, "params.npz")))
    params = _unflat({k: torch.from_numpy(v) for k, v in flat.items()})
    mesh = tp.make_mesh(MESHES[world])
    res = {}
    losses, sp = _train(params, mesh, _batch())
    res["losses"] = np.array(losses)
    for k, v in _flat(gather_to_numpy(sp)).items():
        res[f"p/{k}"] = v
    # the caller's tree is copied, never aliased
    res["caller_untouched"] = np.array(all(
        np.array_equal(params_v.numpy(), flat[k])
        for k, params_v in _flat(params).items()))
    res["placements"] = json.dumps({k: repr(v.placements)
                                    for k, v in _flat(sp).items()})
    res["local_shapes"] = json.dumps({k: list(v.to_local().shape)
                                      for k, v in _flat(sp).items()})
    if world == 1:
        # flash attention inside the step: its plain version and the
        # blockwise backward on CPU tensors
        losses, sp = _train(params, mesh, _batch(),
                            attention_fn=make_flash_attention_fn())
        res["flash_losses"] = np.array(losses)
        for k, v in _flat(gather_to_numpy(sp)).items():
            res[f"flash/{k}"] = v
    if world == 2:
        # 3 rows over 2 data ranks: [0, 2) and [2, 3); the global mean
        losses, sp = _train(params, mesh, _batch(rows=3))
        res["uneven_losses"] = np.array(losses)
        for k, v in _flat(gather_to_numpy(sp)).items():
            res[f"uneven/{k}"] = v
    if world > 1:
        # one step's matmul FLOPs in this rank (2 batch rows per data rank
        # in both meshes): the model axis splits them
        from torch.utils.flop_counter import FlopCounterMode
        step, sp = make_sharded_train_step(_apply(), params, mesh,
                                           learning_rate=LR)
        with FlopCounterMode(display=False) as flops:
            step(sp, _batch())
        res["step_flops"] = np.array(flops.get_total_flops())
    if world == 4:
        from tpulab_torch.models.transformer import init_transformer_params
        odd = init_transformer_params(63, MODEL["d_model"], MODEL["n_heads"],
                                      1, MODEL["d_ff"], device="cpu")
        try:
            make_sharded_train_step(_apply(), odd, mesh)
            res["odd_err"] = "no error"
        except ValueError as e:
            res["odd_err"] = str(e)
        _checkpoint_cases(rank, mesh, params, out_dir, res)
    if rank == 0 or world == 4:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def _checkpoint_cases(rank, mesh, params, out_dir, res):
    batch = _batch()
    ck_dir = os.path.join(out_dir, "ck")
    # the uninterrupted run, saving after step 1 (asynchronously)
    with tp.TrainCheckpointer(ck_dir) as ck:
        full_losses, p_full = _train(params, mesh, batch, steps=4, ckpt=ck,
                                     save_at=1, wait=False)
    # a fresh step function and tree, restored from the checkpoint
    step, fresh = make_sharded_train_step(_apply(), params, mesh,
                                          learning_rate=LR)
    with tp.TrainCheckpointer(ck_dir) as ck2:
        res["latest"] = np.array(ck2.latest_step())
        state = ck2.restore({"step": 0,
                             "params": tp.abstract_like(fresh)})
    res["restored_step"] = np.array(state["step"])
    p = state["params"]
    resumed = []
    for _ in range(2):
        p, loss = step(p, batch)
        resumed.append(float(loss))
    res["full_losses"] = np.array(full_losses)
    res["resumed_losses"] = np.array(resumed)
    a, b = gather_to_numpy(p), gather_to_numpy(p_full)
    res["resume_bits_equal"] = np.array(all(
        np.array_equal(x, _flat(b)[k]) for k, x in _flat(a).items()))

    # retention: 5 saves, the newest 2 kept
    with tp.TrainCheckpointer(os.path.join(out_dir, "keep"),
                              max_to_keep=2) as ck:
        for s in range(5):
            ck.save(s, {"w": torch.full((4,), float(s))}, wait=s % 2 == 0)
        ck.wait()
        res["kept"] = np.array(ck.all_steps())
        res["kept_latest"] = np.array(ck.latest_step())
        res["kept_value"] = ck.restore({"w": torch.zeros(4)})["w"].numpy()

    # save under {"data": 4} sharded on rows, restore onto the 2 x 2 mesh
    # as tpulab's named_sharding(mesh_b, "model", "data")
    mesh_a = tp.make_mesh({"data": 4})
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    xa = shard_from_numpy({"x": x}, mesh_a,
                          {"x": tp.named_sharding(mesh_a, "data", None)})
    cross = os.path.join(out_dir, "cross")
    with tp.TrainCheckpointer(cross) as ck:
        ck.save(0, {"x": xa["x"], "step": 3}, wait=True)
    place_b = tp.named_sharding(mesh, "model", "data")
    with tp.TrainCheckpointer(cross) as ck2:
        got = ck2.restore(tp.abstract_like({"x": x, "step": 0},
                                           {"x": place_b, "step": None},
                                           mesh=mesh))
    res["cross_placements"] = repr(tuple(got["x"].placements))
    res["cross_want_placements"] = repr(place_b)
    res["cross_local_shape"] = np.array(got["x"].to_local().shape)
    res["cross_x"] = gather_to_numpy(got)["x"]
    res["cross_step"] = np.array(got["step"])


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``get(world)``: that world's launch, run once for the module."""
    done = {}

    def get(world):
        if world not in done:
            d = tmp_path_factory.mktemp(f"train{world}")
            np.savez(d / "params.npz", **{k: np.asarray(v) for k, v in
                                          _flat(_jax_params()).items()})
            multihost.launch(_rank_train, world,
                             (world, str(d / "store"), str(d)), timeout=120)
            done[world] = [dict(np.load(d / f"rank{r}.npz"))
                           for r in range(world if world == 4 else 1)]
        return done[world]
    return get


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("world", sorted(MESHES))
def test_losses_match_tpulab(launched, world):
    res = launched(world)
    want, _ = _jax_run(_axes(world))
    np.testing.assert_allclose(res[0]["losses"], want, rtol=RTOL, atol=ATOL)
    assert res[0]["losses"][-1] < res[0]["losses"][0]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_final_params_match_tpulab(launched, world):
    res = launched(world)
    _, want = _jax_run(_axes(world))
    got = {k[2:]: v for k, v in res[0].items() if k.startswith("p/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert bool(res[0]["caller_untouched"])


@pytest.mark.parametrize("world", sorted(MESHES))
def test_params_laid_out_by_the_rules(launched, world):
    """Every leaf is a DTensor on tpulab's rule; a model-sharded leaf's
    local shard is its column / row slice."""
    res = launched(world)
    pl = json.loads(str(res[0]["placements"]))
    shapes = json.loads(str(res[0]["local_shapes"]))
    n_model = MESHES[world]["model"]
    assert pl["layer0/wqkv"] == "(Replicate(), Shard(dim=1))"
    assert pl["layer1/w2"] == "(Replicate(), Shard(dim=0))"
    assert pl["layer0/ln1/scale"] == "(Replicate(), Replicate())"
    d = MODEL["d_model"]
    assert shapes["lm_head"] == [d, MODEL["vocab"] // n_model]
    assert shapes["embed"] == [MODEL["vocab"] // n_model, d]
    assert shapes["layer0/w3"] == [d, MODEL["d_ff"] // n_model]


def test_model_axis_splits_the_step(launched):
    """Over the 2 x 2 mesh a rank runs half the matmul FLOPs of a rank of
    the {"data": 2} mesh on the same rows (Megatron's split, attention
    over half the heads included), and a vocab the model axis does not
    divide is refused."""
    dp, dp_tp = launched(2)[0], launched(4)
    for r in dp_tp:
        assert 2 * int(r["step_flops"]) == int(dp["step_flops"])
        assert str(r["odd_err"]).startswith(
            "embed: dim 0 of (63, 32) does not divide by model=2")


def test_flash_attention_fn_trains_as_dense(launched):
    """The flash wrapper on CPU tensors (plain forward, blockwise
    backward) inside the step: tpulab's dense trajectory."""
    res = launched(1)
    want, want_p = _jax_run(_axes(1))
    np.testing.assert_allclose(res[0]["flash_losses"], want, rtol=RTOL,
                               atol=ATOL)
    for k, v in want_p.items():
        np.testing.assert_allclose(res[0][f"flash/{k}"], v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_uneven_data_shards_give_the_global_mean(launched):
    """3 rows over 2 data ranks ([0, 2) and [2, 3)): the trajectory of
    tpulab's step over the 3 rows on one data shard."""
    res = launched(2)
    want, want_p = _jax_run(_axes(1), rows=3)
    np.testing.assert_allclose(res[0]["uneven_losses"], want, rtol=RTOL,
                               atol=ATOL)
    for k, v in want_p.items():
        np.testing.assert_allclose(res[0][f"uneven/{k}"], v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_checkpoint_resume_is_bit_exact(launched):
    """Saved asynchronously after step 1 of 4 under the 2 x 2 mesh,
    restored into a fresh tree: steps 2 and 3 equal the uninterrupted
    run's, losses and every parameter bit for bit, on every rank."""
    for r in launched(4):
        assert int(r["latest"]) == 1 and int(r["restored_step"]) == 1
        assert list(r["resumed_losses"]) == list(r["full_losses"][2:])
        assert bool(r["resume_bits_equal"])


def test_checkpoint_retention_keeps_the_newest(launched):
    for r in launched(4):
        assert list(r["kept"]) == [3, 4] and int(r["kept_latest"]) == 4
        np.testing.assert_array_equal(r["kept_value"], np.full(4, 4.0))


def test_checkpoint_restores_onto_another_mesh(launched):
    """Rows sharded over {"data": 4} -> the 2 x 2 mesh as tpulab's
    named_sharding(mesh_b, "model", "data"); an int leaf survives."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    for r in launched(4):
        assert str(r["cross_placements"]) == str(r["cross_want_placements"])
        assert str(r["cross_placements"]) == "(Shard(dim=1), Shard(dim=0))"
        assert list(r["cross_local_shape"]) == [4, 4]
        np.testing.assert_array_equal(r["cross_x"], x)
        assert int(r["cross_step"]) == 3


def test_checkpointer_without_a_process_group(tmp_path):
    """One process, no group: DCP without collectives; an int leaf and
    retention as under a mesh."""
    with tp.TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=1) as ck:
        assert ck.latest_step() is None
        with pytest.raises(FileNotFoundError):
            ck.restore({"w": torch.zeros(3)})
        ck.save(0, {"w": torch.arange(3.0), "step": 0})
        ck.save(1, {"w": torch.arange(3.0) + 1, "step": 1}, wait=True)
        assert ck.all_steps() == [1]
        got = ck.restore({"w": torch.zeros(3), "step": -1})
    assert got["step"] == 1
    np.testing.assert_array_equal(got["w"].numpy(), [1.0, 2.0, 3.0])


@pytest.mark.parametrize("lr", [1e-3, 5e-2, 0.3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sgd_update_rounds_as_tpulab(dtype, lr):
    """``sgd_update_`` == tpulab's jitted ``(w - lr * g).astype(w.dtype)``
    bit for bit: under bf16 the learning rate, the product and the
    difference each round to bf16; under f32 XLA's fused multiply-subtract
    rounds once."""
    rng = np.random.default_rng(0)
    jdt = getattr(jnp, dtype)
    w = jnp.asarray(rng.standard_normal(4096), jnp.float32).astype(jdt)
    g = jnp.asarray(rng.standard_normal(4096) * 3, jnp.float32).astype(jdt)
    want = np.asarray(jax.jit(lambda w, g: (w - lr * g).astype(w.dtype))(
        w, g))
    from tpulab_torch.models.convert import tensor_from_numpy
    tw, tg = (tensor_from_numpy(np.asarray(a), "cpu") for a in (w, g))
    sgd_update_(tw, tg, lr)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(tw.view(torch.int16).numpy(),
                                      want.view(np.int16))
        once = (tensor_from_numpy(np.asarray(w), "cpu").float()
                - lr * tg.float()).bfloat16()
        assert not torch.equal(once, tw)   # one rounding would differ
    else:
        np.testing.assert_array_equal(tw.numpy(), want)
        twice = (torch.from_numpy(np.array(w)) - lr * tg).numpy()
        assert not np.array_equal(twice, want)   # two roundings differ


def test_cross_entropy_loss_matches_tpulab():
    from tpulab.parallel.training import cross_entropy_loss as jax_loss
    from tpulab_torch.models.convert import tree_from_numpy

    p = _jax_params()
    batch = _batch()
    want = float(jax.jit(partial(jax_loss, partial(
        jax_apply, n_heads=MODEL["n_heads"], n_layers=MODEL["n_layers"],
        compute_dtype=jnp.float32, n_kv_heads=KV, rope_theta=ROPE)))(
            p, batch))
    tree = tree_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
    got = cross_entropy_loss(_apply(), tree, {k: torch.from_numpy(v).long()
                                              for k, v in batch.items()})
    assert abs(float(got) - want) <= RTOL * abs(want)
