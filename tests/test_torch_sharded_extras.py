"""The sharded batcher's int8 trees, KV-fabric publishing and weight swaps
under a ``{"model": M}`` mesh, against tpulab on the CPU.

tpulab serves one program over fake CPU devices; the port serves M
spawned gloo ranks, rank 0 the coordinator.  One module-scoped launch per
world size (1, 2 and 4 ranks, started together, each joined within 120 s;
4 ranks run the int8 tree under the ragged plan only) runs every case of
that size, while the test process serves the same workloads through
tpulab's batchers at ``mesh=None`` and at ``{"model": 2}``, on
``test_torch_sharded_decode``'s model and its int8 tree from tpulab's
``quantize_transformer_params``, carried over by the weight bridge:

- int8: the port's tokens under both plans equal tpulab's at both
  meshes, logprobs within 1e-5 (f32: two backends, two summation
  orders); each rank's ``w_int8`` / ``scale`` are cut by the parent
  matrix's rule; an int8 tree laid out as tpulab lays it out (replicated
  DTensors) is cut locally to the same shards; int8 shards drawn leaf by
  leaf equal the whole tree quantized, then cut;
- publish: the split-plan owner's publish count, its wire header (digest,
  length, page size), its pages over the prompt's positions and its
  logits row equal tpulab's within 1e-5 (arrays, not blob bytes: tpulab's
  own blobs differ in bytes between meshes); a ``mesh=None`` puller of
  the mesh owner's blobs and a mesh puller of a ``mesh=None`` owner's
  blobs give tpulab's tokens with no prefill of their own;
- swap: a ``WeightMultiplexer`` over the mesh batcher's
  ``BatcherAdapter`` and a second batcher of its size walks tpulab's
  states with tpulab's ``param_bytes``; the streams before the swap,
  after it and after a cold rebuild are bit-identical and tpulab's; a
  follower holds no device weights while cold and one host copy at
  most.
"""

import base64
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.disagg.wire import deserialize_snapshot as jdeserialize
from tpulab.disagg.wire import prompt_digest as jdigest
from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.kvfabric import fabric as jfab
from tpulab.models.quantization import quantize_transformer_params as jquant
from tpulab.modelstore import BatcherAdapter as JAdapter
from tpulab.modelstore import WeightMultiplexer as JMux
from tpulab_torch.kvfabric.fabric import LOGITS_EXTRA
from tpulab_torch.parallel import multihost
from test_torch_sharded_decode import _jax_mesh, _lm_np
from torch_sharded_ranks import (GEO, STEPS_TIMEOUT, SWAP_STEPS,
                                 _main_workload, _prompts, extra_prompts,
                                 extras_cases, publish_workload,
                                 swap_workload)

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
TOL = 1e-5


# ------------------------------------------------------------- tpulab
def _jlm(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _jmake(tree, mesh, **kw):
    return JaxBatcher(tree, compute_dtype=jnp.float32, mesh=mesh, **GEO,
                      **kw)


def _jax_int8(np_int8, mesh):
    cb = _jmake(_jlm(np_int8), mesh, lanes=2, max_len=64)
    try:
        return _main_workload(cb, JaxSampling, _prompts())
    finally:
        cb.shutdown()


def _jax_publish(np_tree, mesh):
    prompts = extra_prompts()["pub"]
    cb = _jmake(_jlm(np_tree), mesh, ragged=False, lanes=1, max_len=64,
                kv_offload=32 << 20, kv_publish=True)
    try:
        out = {"owner": publish_workload(cb, prompts, jdigest,
                                         timeout=300),
               "kv_publishes": cb.kv_publishes}
        blobs = [jfab.fabric_export(cb, jdigest(p)) for p in prompts]
        out["snap"] = [jdeserialize(b) for b in blobs]
        out["blob_len"] = [len(b) for b in blobs]
        return out
    finally:
        cb.shutdown()


def _jax_swap(np_tree, mesh):
    llm = _jmake(_jlm(np_tree), mesh, lanes=1, max_len=64)
    other = _jmake(_jlm(np_tree), None, lanes=1, max_len=64)
    prompt = extra_prompts()["swap"]
    mux = JMux(JAdapter(llm).param_bytes() * 3 // 2)
    try:
        return swap_workload(
            mux, JAdapter(llm, lambda: _jlm(np_tree)),
            JAdapter(other, lambda: _jlm(np_tree)),
            lambda: [int(t) for t in llm.submit(
                prompt, SWAP_STEPS).result(timeout=300)])
    finally:
        mux.close()
        llm.shutdown()
        other.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches (in threads) beside tpulab's batchers."""
    np_tree = _lm_np()
    np_int8 = jax.tree_util.tree_map(np.asarray, jquant(_jlm(np_tree)))
    base = tmp_path_factory.mktemp("extras")

    def launch(world):
        d = base / f"w{world}"
        d.mkdir()
        multihost.launch(extras_cases, world,
                         (world, str(d / "store"), str(d), np_tree, np_int8),
                         timeout=STEPS_TIMEOUT)
        return [np.load(d / f"res{r}.npy", allow_pickle=True).item()
                for r in range(world)]

    with ThreadPoolExecutor(len(WORLDS) + 2) as ex:
        futs = {w: ex.submit(launch, w) for w in WORLDS}
        m2 = _jax_mesh(2)
        jobs = {"int8_none": ex.submit(_jax_int8, np_int8, None),
                "int8_m2": ex.submit(_jax_int8, np_int8, m2)}
        jax_out = {"pub_none": _jax_publish(np_tree, None),
                   "pub_m2": _jax_publish(np_tree, m2),
                   "swap_m2": _jax_swap(np_tree, m2)}
        jax_out.update({k: f.result() for k, f in jobs.items()})
        port = {w: f.result() for w, f in futs.items()}
    return {"port": port, "jax": jax_out}


def _coord(runs, w):
    return runs["port"][w][0]


# ----------------------------------------------------------------- int8
INT8 = [(w, plan) for w in WORLDS for plan in ("ragged", "split")
        if w < 4 or plan == "ragged"]


@pytest.mark.parametrize("w,plan", INT8,
                         ids=[f"m{w}-{plan}" for w, plan in INT8])
def test_int8_tree_serves_tpulabs_tokens(runs, w, plan):
    """Greedy (page crossings), device-sampled, host-sampled, logprobs
    and the dry run's pair on the int8 tree: tpulab's tokens at mesh=None
    and at {"model": 2}, logprobs within 1e-5; pages come home."""
    got = _coord(runs, w)[f"int8/{plan}"]
    for ref in (runs["jax"]["int8_none"], runs["jax"]["int8_m2"]):
        for key, want in ref.items():
            if key == "logprobs_lp":
                np.testing.assert_allclose(got[key], want, rtol=0, atol=TOL)
            else:
                assert got[key] == want, (key, got[key], want)
    free, total = _coord(runs, w)[f"int8/{plan}/free"]
    assert free == total


@pytest.mark.parametrize("w", WORLDS)
def test_int8_entries_are_cut_by_their_parent_rule(runs, w):
    """Column-parallel wqkv / w1: w_int8 and the per-column scale cut on
    the output columns; row-parallel wo / w2: w_int8 cut on its rows, the
    scale whole.  Every rank holds 1/M of the int8 bytes."""
    for r in runs["port"][w]:
        s = r["int8_shapes"]
        assert s["wqkv"] == {"w_int8": [32, 96 // w], "scale": [96 // w]}
        assert s["w1"] == {"w_int8": [32, 64 // w], "scale": [64 // w]}
        assert s["wo"] == {"w_int8": [32 // w, 32], "scale": [32]}
        assert s["w2"] == {"w_int8": [64 // w, 32], "scale": [32]}


@pytest.mark.parametrize("w", WORLDS[:2])
def test_int8_replicated_dtensor_tree_is_cut_locally(runs, w):
    """An int8 tree of DTensors laid out by tpulab's rules (its int8
    leaves replicated) gives every rank the same shards as the whole
    tree, and the same greedy stream."""
    for r in runs["port"][w]:
        same, shapes = r["int8_replicated_dtensor"]
        assert same and shapes == r["int8_shapes"]
    got = _coord(runs, w)["int8_replicated_tokens"]
    assert got == _coord(runs, w)["int8/ragged"]["greedy2"][:20]


@pytest.mark.parametrize("w", WORLDS[:2])
def test_int8_shards_drawn_whole_then_cut(runs, w):
    """init_transformer_shards(quantize=True) quantizes each projection
    whole before it cuts it: its shards equal the whole int8 tree's (a
    SwiGLU tree with an untied, quantized lm_head), bit for bit."""
    for r in runs["port"][w]:
        n, equal = r["int8_drawn_equal"]
        assert n == 4 + 2 * (2 + 5 * 2) and equal


# -------------------------------------------------------------- publish
def _logits(header):
    return np.frombuffer(base64.b64decode(header[LOGITS_EXTRA]), np.float32)


def _valid(arr, length):
    """The snapshot's rows at the prompt's positions (pages x slots)."""
    a = np.asarray(arr, np.float32)
    a = np.moveaxis(a, 1, 2)                      # (L, 2, n, S, H, D)
    a = a.reshape(a.shape[:2] + (-1,) + a.shape[4:])
    return a[:, :, :length]


@pytest.mark.parametrize("w", WORLDS[:2])
def test_mesh_owner_publishes_tpulabs_snapshots(runs, w):
    """The split-plan owner under {"model": w} publishes each distinct
    prompt once; its streams, wire header, pages and logits row are
    tpulab's at mesh=None and at {"model": 2}."""
    r = _coord(runs, w)
    assert r["pub/kv_publishes"] == 2
    for key in ("pub_none", "pub_m2"):
        ref = runs["jax"][key]
        assert ref["kv_publishes"] == 2
        assert r["pub/owner"] == ref["owner"]
        assert r["pub/blob_len"] == ref["blob_len"]
        for (arr, head), (jarr, jhead) in zip(r["pub/snap"], ref["snap"]):
            for k in ("digest", "length", "page_size", "first_token"):
                assert head[k] == jhead[k], k
            assert arr.shape == jarr.shape and arr.dtype == jarr.dtype
            n = head["length"]
            np.testing.assert_allclose(_valid(arr, n), _valid(jarr, n),
                                       rtol=0, atol=TOL)
            np.testing.assert_allclose(_logits(head), _logits(jhead),
                                       rtol=0, atol=TOL)


@pytest.mark.parametrize("w", WORLDS[:2])
def test_mesh_owner_blobs_pull_into_a_single_device_batcher(runs, w):
    """A mesh=None puller admits the mesh owner's blobs through
    submit_shipped and decodes tpulab's streams, prefilling nothing."""
    streams, prefills = _coord(runs, w)["pub/pull_single"]
    assert streams == runs["jax"]["pub_none"]["owner"][:2]
    assert prefills == 0


@pytest.mark.parametrize("w", WORLDS[:2])
def test_single_device_blobs_pull_into_a_mesh_batcher(runs, w):
    """A {"model": w} puller admits a mesh=None owner's blobs (the whole
    store's heads, scattered to every rank's) and decodes tpulab's
    streams, prefilling nothing."""
    streams, prefills = _coord(runs, w)["pub/pull_mesh"]
    assert streams == runs["jax"]["pub_m2"]["owner"][:2]
    assert prefills == 0


# ----------------------------------------------------------------- swap
@pytest.mark.parametrize("w", WORLDS[:2])
def test_multiplexer_walks_tpulabs_states(runs, w):
    """Registered hot; pushed out by the second servable (cold, not
    resident); acquired back hot; pushed out again; cold-rebuilt after
    the host tier lost its tree: tpulab's states, counters and
    param_bytes (the whole tree's)."""
    got, want = _coord(runs, w)["swap"], runs["jax"]["swap_m2"]
    assert got["states"] == want["states"]
    assert got["states"][1][0] == "cold" and got["states"][2][0] == "hot"
    assert got["param_bytes"] == want["param_bytes"]
    assert got["counts"] == want["counts"]
    assert got["resident_cold"] is want["resident_cold"] is False


@pytest.mark.parametrize("w", WORLDS[:2])
def test_swapped_and_rebuilt_weights_serve_the_same_tokens(runs, w):
    """Before the swap, after it and after the cold rebuild: the same
    stream bit for bit, and tpulab's."""
    got = _coord(runs, w)["swap"]["tokens"]
    want = runs["jax"]["swap_m2"]["tokens"]
    assert got[0] == got[1] == got[2] == want[0] == want[1] == want[2]


def test_followers_replay_the_swaps(runs):
    """The coordinator holds no weights while cold; its follower replays
    each swap in order: out (no device weights, one host copy), in from
    the host copy (dropped), out, in from the builder (a cold rebuild,
    no host copy left)."""
    coord, follower = runs["port"][2]
    assert coord["swap"]["cold"] is True
    assert coord["swap/follower"] == []
    assert follower["swap/follower"] == [
        ["out", True, True], ["in", True, True, False],
        ["out", True, True], ["in", True, True, True]]


def test_unpicklable_builder_refused_under_a_mesh(runs):
    """Every rank runs a cold rebuild's builder, so under a mesh it must
    travel pickled: a lambda is refused when the adapter is made."""
    err = _coord(runs, 2)["swap/lambda"]
    assert err.startswith("TypeError") and "must pickle" in err
