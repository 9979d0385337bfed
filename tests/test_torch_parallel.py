"""tpulab_torch.parallel against tpulab.parallel on the CPU.

Multi-rank cases run in one launch of 4 spawned gloo ranks over a
``FileStore`` under the test's temporary directory, joined within 120 s;
the per-axis cases run over an axis of all 4 ranks and over the inner
axis of a 2 x 2 mesh (two lines of 2).  Every rank writes its results to
a file and the test process holds them against tpulab on the same numpy
inputs and weights.  tpulab's ``shard_map`` bodies cannot run here as tpulab calls
them (jax 0.9.0's ``shard_map`` takes no ``check_rep``), so the oracles
are tpulab's per-device bodies under ``jax.vmap(axis_name=)`` over the
stacked shards (``_ring_attn_local``, ``_ulysses_local``), its dense
``moe_ffn`` and sequential stage application, its
``dense_attention``, and its ``transformer_apply`` on the whole sequence
for a rope model each rank runs on its sequence shard.  Tolerance: f32, 1e-5 (two backends, two summation
orders; measured errors are below 1e-6).  Meshes, specs and error
messages are compared exactly.
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.models.mnist import make_mnist as jax_make_mnist
from tpulab.models.transformer import dense_attention as jax_dense
from tpulab.models.transformer import init_transformer_params as jax_init
from tpulab.models.transformer import make_moe_transformer as jax_moe_model
from tpulab.models.transformer import transformer_apply as jax_apply
from tpulab.parallel import MultiDeviceDispatcher as JaxDispatcher
from tpulab.parallel import default_mesh as jax_default_mesh
from tpulab.parallel import kv_pool_sharding as jax_kv_rule
from tpulab.parallel import make_mesh as jax_make_mesh
from tpulab.parallel import transformer_param_shardings as jax_rules
from tpulab.parallel.moe import _gates as jax_gates
from tpulab.parallel.moe import init_moe_params as jax_init_moe
from tpulab.parallel.moe import moe_ffn as jax_moe_ffn
from tpulab.parallel.pipeline import make_pipeline as jax_make_pipeline
from tpulab.parallel.ring_attention import (_ring_attn_local, _ulysses_local,
                                            ulysses_attention as jax_ulysses)
import tpulab_torch.parallel as tp
from tpulab_torch.models.convert import tree_from_numpy
from tpulab_torch.models.mnist import make_mnist
from tpulab_torch.models.transformer import (init_transformer_params,
                                             make_moe_transformer,
                                             transformer_apply)
from tpulab_torch.parallel import moe as tmoe
from tpulab_torch.parallel import multihost
from tpulab_torch.parallel.mesh import mesh_shape

torch.set_num_threads(2)

TOL = 1e-5
WORLD = 4
AXES = (2, 4)     # the axis sizes of the per-rank cases
ATTN = dict(b=2, t_local=8, h=4, d=8)
MOE = dict(d_model=32, d_ff=64, n_experts=8, n_tokens=16)
PP = dict(d=32, mb=4)
# a rope GQA model run with its sequence sharded over the axis
ROPE_LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               n_kv_heads=2, rope_theta=10000.0)


# ----------------------------------------------------------------- inputs
def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _inputs(n):
    """The inputs of the cases over an axis of ``n`` ranks."""
    rng = np.random.default_rng(n)
    a = ATTN
    shape = (a["b"], a["t_local"] * n, a["h"], a["d"])
    moe = _np_tree(jax_init_moe(MOE["d_model"], MOE["d_ff"],
                                MOE["n_experts"], seed=0))
    stages = [{"w": (rng.standard_normal((PP["d"], PP["d"])) * 0.3
                     ).astype(np.float32),
               "b": (rng.standard_normal((PP["d"],)) * 0.1
                     ).astype(np.float32)} for _ in range(n)]
    return {
        **{n: rng.standard_normal(shape).astype(np.float32)
           for n in ("q", "k", "v")},
        **{f"moe/{k}": v for k, v in moe.items()},
        "moe_x": rng.standard_normal((MOE["n_tokens"], MOE["d_model"])
                                     ).astype(np.float32),
        **{f"stage{i}/{k}": v for i, s in enumerate(stages)
           for k, v in s.items()},
        "pp_x4": rng.standard_normal((4, PP["mb"], PP["d"])
                                     ).astype(np.float32),
        "pp_x1": rng.standard_normal((1, PP["mb"], PP["d"])
                                     ).astype(np.float32),
        **{f"lm/{k}": v for k, v in _flat(_np_tree(_rope_lm())).items()},
        "lm_tokens": rng.integers(0, ROPE_LM["vocab"],
                                  (a["b"], a["t_local"] * n), np.int32),
    }


def _rope_lm():
    m = ROPE_LM
    return jax_init(m["vocab"], m["d_model"], m["n_heads"], m["n_layers"],
                    m["d_ff"], seed=3, n_kv_heads=m["n_kv_heads"],
                    ffn="swiglu", tie_embeddings=False)


def _lm_kwargs():
    m = ROPE_LM
    return dict(n_heads=m["n_heads"], n_layers=m["n_layers"],
                n_kv_heads=m["n_kv_heads"], rope_theta=m["rope_theta"])


def _jax_spec_tree(world):
    """tpulab's spec of every leaf of a 3-layer GQA SwiGLU untied tree, on
    a (data, model) mesh and on a ("tp",) mesh, plus its pool rule."""
    params = jax_init(64, 16, 2, 3, 32, ffn="swiglu", tie_embeddings=False)
    mesh = jax_make_mesh({"data": world // 2, "model": 2})
    specs = _flat(jax_rules(params, mesh))
    tp_specs = _flat(jax_rules(params, jax_make_mesh({"tp": 2}),
                               model_axis="tp"))
    as_list = lambda s: [list(e) if isinstance(e, tuple) else e
                         for e in tuple(s.spec)]
    return {"main": {k: as_list(v) for k, v in specs.items()},
            "tp": {k: as_list(v) for k, v in tp_specs.items()},
            "kv": as_list(jax_kv_rule(jax_make_mesh({"model": 2}))),
            "kv_tp": as_list(jax_kv_rule(jax_make_mesh({"tp": 2}),
                                         model_axis="tp"))}


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


# ------------------------------------------------------------ rank bodies
def _axis_mesh(world, name, n):
    """An axis ``name`` of ``n`` ranks: the whole world, or the inner axis
    of a (world / n, n) mesh (rank r at position r % n)."""
    if n == world:
        return tp.make_mesh({name: n})
    return tp.make_mesh({"x": world // n, name: n})


def _axis_cases(rank, world, n, inp, res):
    """Ring, Ulysses, expert-parallel and pipeline cases over an axis of
    ``n`` ranks; keys ``p{n}/...``."""
    pos, key = rank % n, lambda k: f"p{n}/{k}"
    sp = _axis_mesh(world, "sp", n)
    t = ATTN["t_local"]
    q, k, v = (torch.from_numpy(inp[c][:, pos * t:(pos + 1) * t])
               for c in ("q", "k", "v"))
    for causal in (True, False):
        res[key(f"ring_{causal}")] = tp.ring_attention(sp, "sp", causal)(
            q, k, v).numpy()
        res[key(f"ulysses_{causal}")] = tp.ulysses_attention(
            sp, "sp", causal)(q, k, v).numpy()
    # the rope model on this rank's token shard: rope at global positions
    lm = {}
    for path, w in inp.items():
        if path.startswith("lm/"):
            node = lm
            *dirs, leaf = path[3:].split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = torch.from_numpy(w)
    mine = torch.from_numpy(inp["lm_tokens"][:, pos * t:(pos + 1) * t])
    for kind in ("ring", "ulysses"):
        fn = getattr(tp, f"{kind}_attention")(sp, "sp")
        with torch.no_grad():
            res[key(f"lm_{kind}")] = transformer_apply(
                lm, {"tokens": mine}, compute_dtype=torch.float32,
                attention_fn=fn, **_lm_kwargs())["logits"].numpy()
    h = n // 2
    res[key("ulysses_err")] = _error(lambda: tp.ulysses_attention(sp, "sp")(
        q[:, :, :h], k[:, :, :h], v[:, :, :h]))

    # expert parallelism over ep: every rank gets the whole output
    ep = _axis_mesh(world, "ep", n)
    moe = {c: torch.from_numpy(inp[f"moe/{c}"])
           for c in ("router", "w1", "w2")}
    x = torch.from_numpy(inp["moe_x"])
    for top_k in (1, 2):
        ffn, shard = tp.make_expert_parallel_ffn(ep, "ep", top_k=top_k)
        res[key(f"ep_top{top_k}")] = ffn(shard(moe), x).numpy()
    tied = dict(moe, router=torch.zeros_like(moe["router"]))
    res[key("ep_tied")] = ffn(shard(tied), x).numpy()

    # pipeline over pp, one stage a rank
    from tpulab_torch.parallel.pipeline import stack_stage_params
    pp = _axis_mesh(world, "pp", n)
    stages = [{c: torch.from_numpy(inp[f"stage{i}/{c}"]) for c in ("w", "b")}
              for i in range(n)]
    stage_fn = lambda p, x: torch.nn.functional.gelu(
        x @ p["w"] + p["b"], approximate="tanh")
    pipeline, shard = tp.make_pipeline(pp, stage_fn, axis_name="pp")
    stacked = shard(stack_stage_params(stages))
    for m in (1, 4):
        res[key(f"pp_{m}")] = pipeline(stacked, torch.from_numpy(
            inp[f"pp_x{m}"])).numpy()
    res[key("pp_err")] = _error(
        lambda: shard(stack_stage_params(stages * 2)))


def _rank_cases(rank, world, store, out_dir):
    """Every multi-rank case of this file, in one rank."""
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    with open(os.path.join(out_dir, "specs.json")) as f:
        jspecs = json.load(f)
    res = {}

    # meshes and their errors
    mesh = tp.make_mesh({"data": world // 2, "model": 2})
    res["mesh"] = json.dumps(mesh_shape(mesh))
    res["default_mesh"] = json.dumps(mesh_shape(tp.default_mesh(n_model=2)))
    res["err_too_many"] = _error(lambda: tp.make_mesh({"data": 2 * world}))
    res["err_too_many_2d"] = _error(
        lambda: tp.make_mesh({"data": 3, "model": world}))
    res["err_default"] = _error(lambda: tp.default_mesh(n_model=3))

    # the spec tree: the port's rules against tpulab's specs mapped
    # through named_sharding, leaf for leaf
    params = init_transformer_params(64, 16, 2, 3, 32, ffn="swiglu",
                                     tie_embeddings=False, device="cpu")
    tp_mesh = tp.make_mesh({"tp": world})
    for name, m, axis in (("main", mesh, "model"), ("tp", tp_mesh, "tp")):
        ours = _flat(tp.transformer_param_shardings(params, m,
                                                    model_axis=axis))
        res[f"spec_{name}"] = json.dumps({
            k: [repr(ours[k]), repr(tp.named_sharding(m, *s))]
            for k, s in jspecs[name].items()})
        res[f"spec_{name}_keys"] = json.dumps(sorted(ours))
    res["kv"] = json.dumps([repr(tp.kv_pool_sharding(mesh)),
                            repr(tp.named_sharding(mesh, *jspecs["kv"]))])
    res["kv_tp"] = json.dumps([
        repr(tp.kv_pool_sharding(tp_mesh, model_axis="tp")),
        repr(tp.named_sharding(tp_mesh, *jspecs["kv_tp"]))])

    for n in AXES:
        _axis_cases(rank, world, n, {k[len(f"p{n}/"):]: v
                                     for k, v in inp.items()
                                     if k.startswith(f"p{n}/")}, res)

    # a pool under the mesh: this rank's KV heads (of 2) on the model axis
    from tpulab_torch.engine.paged import PagedKVPool
    pool = PagedKVPool(4, 8, 1, 2, 8, torch.float32, device="cpu",
                       mesh=mesh)
    res["pool"] = json.dumps([list(pool.kv.shape), pool.n_shards,
                              pool.hbm_bytes, pool.hbm_bytes_per_shard])
    del pool

    res["slice"] = np.array(multihost.local_data_slice(5, mesh))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of WORLD gloo ranks; every rank's results."""
    d = tmp_path_factory.mktemp("parallel")
    np.savez(d / "inputs.npz", **{f"p{n}/{k}": v for n in AXES
                                  for k, v in _inputs(n).items()})
    (d / "specs.json").write_text(json.dumps(_jax_spec_tree(WORLD)))
    multihost.launch(_rank_cases, WORLD, (WORLD, str(d / "store"), str(d)),
                     timeout=120)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _s(x):
    return str(x[()]) if isinstance(x, np.ndarray) else x


# ------------------------------------------------------------ mesh tests
def test_public_names_are_tpulabs():
    """tpulab's ``__all__`` plus the bodies and the training entry point
    tpulab exposes by module path, each importable."""
    import tpulab.parallel as jp

    extra = {"ring_attention", "ulysses_attention",
             "make_expert_parallel_ffn", "make_pipeline",
             "make_sharded_train_step", "multihost"}
    assert set(tp.__all__) == set(jp.__all__) | extra
    assert all(getattr(tp, name) is not None for name in tp.__all__)


def test_a_pool_under_a_mesh_cites_the_next_item(ranks):
    """A pool under a mesh holds its rank's KV heads: over the model axis
    of the 2 x 2 mesh each rank's store is (L, P, 2, S, Hkv/2, D), with
    tpulab's placements and logical bytes.  The batcher's adapter under
    a mesh runs (tests/test_torch_sharded_decode.py and
    tests/test_torch_sharded_extras.py hold the serving path): the
    BatcherAdapter of a mesh batcher reports the whole tree's bytes, as
    tpulab counts them, and takes only a builder every rank can run
    (one that pickles)."""
    from types import SimpleNamespace

    from tpulab_torch.modelstore import BatcherAdapter

    for r in ranks:
        shape, shards, logical, per_shard = json.loads(_s(r["pool"]))
        assert shape == [1, 4, 2, 8, 1, 8] and shards == 2
        assert logical == 2 * per_shard == 4 * 2 * 8 * 2 * 8 * 4
    batcher = SimpleNamespace(mesh=object(), tree_bytes=logical, params={},
                              pool=SimpleNamespace(device="cpu"))
    assert BatcherAdapter(batcher).param_bytes() == logical
    with pytest.raises(TypeError, match="must pickle"):
        BatcherAdapter(batcher, lambda: {})


def test_meshes_and_their_errors(ranks):
    jax_devs = jax.devices()[:WORLD]
    for r in ranks:
        assert json.loads(_s(r["mesh"])) == {"data": 2, "model": 2}
        assert json.loads(_s(r["default_mesh"])) == {"data": 2, "model": 2}
        # tpulab's own messages over as many devices as the port has ranks
        assert _s(r["err_too_many"]) == _error(
            lambda: jax_make_mesh({"data": 2 * WORLD}, jax_devs))
        assert _s(r["err_too_many_2d"]) == _error(
            lambda: jax_make_mesh({"data": 3, "model": WORLD}, jax_devs))
        assert _s(r["err_default"]) == _error(
            lambda: jax_default_mesh(n_model=3, devices=jax_devs))


def test_spec_tree_matches_tpulab(ranks):
    """transformer_param_shardings equals tpulab's rules mapped through
    named_sharding at every leaf, on (data, model) and on a custom axis;
    the pool rule too."""
    jspecs = _jax_spec_tree(WORLD)
    for r in ranks:
        for name in ("main", "tp"):
            pairs = json.loads(_s(r[f"spec_{name}"]))
            assert sorted(pairs) == json.loads(_s(r[f"spec_{name}_keys"]))
            assert sorted(pairs) == sorted(jspecs[name])
            for path, (ours, mapped) in pairs.items():
                assert ours == mapped, (name, path)
        assert len(set(json.loads(_s(r["kv"])))) == 1
        assert len(set(json.loads(_s(r["kv_tp"])))) == 1
    main = json.loads(_s(ranks[0]["spec_main"]))
    assert main["layer0/wqkv"][0] == "(Replicate(), Shard(dim=1))"
    assert main["layer2/w2"][0] == "(Replicate(), Shard(dim=0))"
    assert main["embed"][0] == "(Replicate(), Shard(dim=0))"
    assert main["lm_head"][0] == "(Replicate(), Shard(dim=1))"
    assert main["final_norm/scale"][0] == "(Replicate(), Replicate())"
    assert json.loads(_s(ranks[0]["kv"]))[0] == \
        "(Replicate(), Shard(dim=4))"


def test_named_sharding_rejects_what_dtensor_cannot_lay_out():
    names = ("data", "model")

    class _Mesh:                     # the rule reads the axis names only
        mesh_dim_names = names
    with pytest.raises(ValueError, match="not in mesh axes"):
        tp.named_sharding(_Mesh(), "seq")
    with pytest.raises(ValueError, match="shards two dims"):
        tp.named_sharding(_Mesh(), "data", "data")
    with pytest.raises(NotImplementedError, match="mesh order"):
        tp.named_sharding(_Mesh(), ("model", "data"))
    assert repr(tp.named_sharding(_Mesh(), ("data", "model"))) == \
        "(Shard(dim=0), Shard(dim=0))"
    assert repr(tp.kv_pool_sharding(_Mesh())) == \
        "(Replicate(), Shard(dim=4))"


def test_local_data_slice_over_the_data_axis(ranks):
    """tpulab's arithmetic over the data coordinate: 5 rows over 2, the
    remainder to the first."""
    for rank, r in enumerate(ranks):
        assert tuple(r["slice"]) == ((0, 3) if rank // 2 == 0 else (3, 5))


# ------------------------------------------------------- attention tests
def _stacked(x, n):
    return jnp.stack(jnp.split(jnp.asarray(x), n, axis=1))


def _lines(ranks, n):
    """The rank lists of each axis line of size ``n``."""
    return [ranks[i:i + n] for i in range(0, WORLD, n)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("n", AXES, ids=lambda n: f"p{n}")
def test_sequence_parallel_matches_tpulab_bodies(ranks, n, kind, causal):
    """The port's per-rank bodies against tpulab's under jax.vmap over
    the same shards, and against dense attention."""
    inp = _inputs(n)
    body = _ring_attn_local if kind == "ring" else _ulysses_local
    want = jax.vmap(partial(body, axis_name="x", causal=causal),
                    axis_name="x")(*(_stacked(inp[c], n)
                                     for c in ("q", "k", "v")))
    want = np.concatenate(list(np.asarray(want)), axis=1)
    dense = np.asarray(jax_dense(*(jnp.asarray(inp[c])
                                   for c in ("q", "k", "v")), causal=causal))
    for line in _lines(ranks, n):
        got = np.concatenate([r[f"p{n}/{kind}_{causal}"] for r in line],
                             axis=1)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("n", AXES, ids=lambda n: f"p{n}")
def test_sequence_parallel_transformer_matches_tpulab_dense(ranks, n, kind):
    """A rope GQA model with each rank's ``transformer_apply`` on its
    sequence shard and the sequence-parallel ``attention_fn``: the
    concatenated logits equal tpulab's ``transformer_apply`` on the whole
    sequence (rope at global positions on every rank)."""
    inp = _inputs(n)
    want = np.asarray(jax.jit(partial(
        jax_apply, compute_dtype=jnp.float32, **_lm_kwargs()))(
            _rope_lm(), {"tokens": inp["lm_tokens"]})["logits"])
    for line in _lines(ranks, n):
        got = np.concatenate([r[f"p{n}/lm_{kind}"] for r in line], axis=1)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", AXES, ids=lambda n: f"p{n}")
def test_ulysses_rejects_heads_not_divisible(ranks, n):
    q = jnp.zeros((1, 4 * n, n // 2, 8), jnp.float32)
    want = _error(lambda: jax_ulysses(jax_make_mesh({"sp": n}), "sp")(
        q, q, q))
    assert "not divisible" in want
    for r in ranks:
        assert _s(r[f"p{n}/ulysses_err"]) == want


# ------------------------------------------------------------- MoE tests
@pytest.mark.parametrize("case", ["top1", "top2", "tied"])
@pytest.mark.parametrize("n", AXES, ids=lambda n: f"p{n}")
def test_expert_parallel_matches_tpulab_dense(ranks, n, case):
    """Experts sharded over ep, all_reduce combine == tpulab's dense
    moe_ffn on the same params; tied router logits pick tpulab's k."""
    inp = _inputs(n)
    params = {c: jnp.asarray(inp[f"moe/{c}"]) for c in ("router", "w1",
                                                         "w2")}
    if case == "tied":
        params["router"] = jnp.zeros_like(params["router"])
    want = np.asarray(jax_moe_ffn(params, jnp.asarray(inp["moe_x"]),
                                  top_k=1 if case == "top1" else 2))
    key = f"p{n}/ep_{case}" if case == "tied" else f"p{n}/ep_top{case[-1]}"
    for r in ranks:             # every rank holds the whole output
        np.testing.assert_allclose(r[key], want, rtol=TOL, atol=TOL)


# -------------------------------------------------------- pipeline tests
@pytest.mark.parametrize("n_micro", [1, 4])
@pytest.mark.parametrize("n", AXES, ids=lambda n: f"p{n}")
def test_pipeline_matches_sequential_stages(ranks, n, n_micro):
    """GPipe over pp == tpulab's stages applied in sequence."""
    inp = _inputs(n)
    x = jnp.asarray(inp[f"pp_x{n_micro}"])
    want = x
    for i in range(n):
        w, b = (jnp.asarray(inp[f"stage{i}/{c}"]) for c in ("w", "b"))
        want = jax.nn.gelu(want @ w + b)
    for r in ranks:
        np.testing.assert_allclose(r[f"p{n}/pp_{n_micro}"], np.asarray(want),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", AXES, ids=lambda n: f"p{n}")
def test_pipeline_rejects_stage_mesh_mismatch(ranks, n):
    _, shard = jax_make_pipeline(jax_make_mesh({"pp": n}),
                                 lambda p, x: x, axis_name="pp")
    want = _error(lambda: shard({"w": jnp.zeros((2 * n, 8, 8))}))
    assert "pipeline axis" in want
    for r in ranks:
        assert _s(r[f"p{n}/pp_err"]) == want


# ------------------------------------------- single-process MoE and model
@pytest.mark.parametrize("top_k", [1, 2, 8], ids=["top1", "top2", "all"])
def test_gates_match_tpulab(top_k):
    p = _np_tree(jax_init_moe(16, 32, 8, seed=2))
    x = np.random.default_rng(3).standard_normal((12, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jax_gates, static_argnums=2)(
        p, jnp.asarray(x), top_k))
    got = tmoe._gates(tree_from_numpy(p, "cpu"), torch.from_numpy(x),
                      top_k).numpy()
    assert ((got > 0) == (want > 0)).all()
    assert ((got > 0).sum(-1) == min(top_k, 8)).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_tied_logits_select_tpulabs_k_experts(top_k):
    """Uniform router logits (zero tokens): exactly k experts fire, the
    lowest-indexed ones, as jax.lax.top_k breaks the ties."""
    p = _np_tree(jax_init_moe(16, 32, 4, seed=0))
    zeros = np.zeros((3, 16), np.float32)
    want = np.asarray(jax.jit(jax_gates, static_argnums=2)(
        p, jnp.asarray(zeros), top_k))
    got = tmoe._gates(tree_from_numpy(p, "cpu"), torch.from_numpy(zeros),
                      top_k).numpy()
    assert ((got > 0).sum(-1) == top_k).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,dtype,tol", [
    (1, "float32", TOL), (2, "float32", TOL), (2, "bfloat16", 3e-2)])
def test_moe_ffn_matches_tpulab(top_k, dtype, tol):
    p = _np_tree(jax_init_moe(32, 64, 8, seed=0))
    x = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(partial(
        jax_moe_ffn, top_k=top_k, compute_dtype=getattr(jnp, dtype)))(
            p, jnp.asarray(x)), np.float32)
    got = tmoe.moe_ffn(tree_from_numpy(p, "cpu"), torch.from_numpy(x),
                       top_k=top_k, compute_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_init_moe_params_is_seeded():
    a = tmoe.init_moe_params(8, 16, 4, seed=5, device="cpu")
    b = tmoe.init_moe_params(8, 16, 4, seed=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "router": (8, 4), "w1": (4, 8, 16), "w2": (4, 16, 8)}
    assert all(torch.equal(a[k], b[k]) for k in a)


_MOE_MODEL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                  n_experts=4, seq_len=16, max_batch_size=2)


@pytest.mark.parametrize("compute,tol", [("float32", 1e-4),
                                         ("bfloat16", 3e-2)])
def test_moe_transformer_logits_match_tpulab(compute, tol):
    """make_moe_transformer on tpulab's weights (the bridge carries the
    per-layer expert banks) == tpulab's logits."""
    jm = jax_moe_model(**_MOE_MODEL, compute_dtype=getattr(jnp, compute))
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16), np.int32)
    want = np.asarray(jax.jit(jm.apply_fn)(jm.params,
                                            {"tokens": tokens})["logits"])
    m = make_moe_transformer(**_MOE_MODEL,
                             compute_dtype=getattr(torch, compute),
                             params=tree_from_numpy(_np_tree(jm.params),
                                                    "cpu"))
    assert m.name == "moe_transformer" and m.params["layer1"]["moe"][
        "w1"].shape == (4, 32, 64)
    with torch.inference_mode():
        got = m.apply_fn(m.params, {"tokens": torch.from_numpy(tokens)}
                         )["logits"]
    assert got.shape == (2, 16, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_moe_transformer_serves_through_the_port():
    """tpulab's test_moe_transformer_serves on the port: finite logits,
    equal to the direct forward bit for bit."""
    from tpulab_torch.engine.inference_manager import InferenceManager

    model = make_moe_transformer(**dict(_MOE_MODEL, max_batch_size=2),
                                 compute_dtype=torch.float32, device="cpu")
    mgr = InferenceManager(max_executions=1, device="cpu")
    mgr.register_model("moe", model)
    mgr.update_resources()
    try:
        toks = np.random.default_rng(0).integers(0, 64, (1, 16), np.int32)
        out = mgr.infer_runner("moe").infer(tokens=toks).result(timeout=120)
        assert out["logits"].shape == (1, 16, 64)
        assert np.isfinite(out["logits"]).all()
        with torch.inference_mode():
            direct = model.apply_fn(model.params,
                                    {"tokens": torch.from_numpy(toks)})
        np.testing.assert_array_equal(out["logits"],
                                      direct["logits"].numpy())
    finally:
        mgr.shutdown()


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_dispatcher_policies_with_mnist(policy):
    """Two port managers on the CPU serve tpulab's MNIST weights: outputs
    equal tpulab's forward, the policy's picks, in-flight counts back to
    0; tpulab's constructor errors."""
    import time

    jm = jax_make_mnist(max_batch_size=1, seed=3)
    tree = tree_from_numpy(_np_tree(jm.params), "cpu")
    disp = tp.MultiDeviceDispatcher.create(
        lambda: make_mnist(max_batch_size=1, params=tree), "mnist",
        devices=["cpu", "cpu"], max_executions=1, policy=policy)
    forward = jax.jit(jm.apply_fn)
    try:
        xs = np.random.default_rng(0).standard_normal(
            (4, 1, 28, 28, 1)).astype(np.float32)
        for x in xs:
            want = np.asarray(forward(jm.params, {"Input3": x})[
                "Plus214_Output_0"])
            got = disp.infer("mnist", Input3=x).result(timeout=60)
            np.testing.assert_allclose(got["Plus214_Output_0"], want,
                                       rtol=TOL, atol=TOL)
        assert disp.device_count == 2
        assert disp.manager(0) is not disp.manager(1)
        deadline = time.monotonic() + 10
        while disp.inflight() != [0, 0]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        if policy == "round_robin":
            assert [disp._pick() for _ in range(4)] == [0, 1, 0, 1]
        else:
            disp._inflight[0] = 1     # a request held on manager 0
            assert disp._pick() == 1
            disp._inflight[0] = 0
    finally:
        disp.shutdown()
    for bad, policy_, cls in (([], "round_robin", JaxDispatcher),
                              ([object()], "random", JaxDispatcher)):
        with pytest.raises(ValueError) as want:
            cls(bad, policy=policy_)
        with pytest.raises(ValueError, match=str(want.value)):
            tp.MultiDeviceDispatcher(bad, policy=policy_)
