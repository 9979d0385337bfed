"""tpulab_torch.disagg against tpulab.disagg, on the CPU.

- the wire format: the port's blob is tpulab's byte for byte (f32 and
  bf16 payloads), each side reads the other's, and bad magic, version
  skew, truncation and a CRC flip are rejected;
- shipping: a prefill batcher exports (``submit(export_digest=...)``),
  a second batcher imports and admits with ``submit_shipped`` — zero
  prefill on the decode side, and the stream of a unified tpulab batcher
  on the same weights (greedy under the repo's margin rule,
  device-sampled exactly);
- lost shipments (the ``disagg.ship`` fault site, a corrupt blob, a
  geometry mismatch) degrade to a local prefill with the same tokens;
- host-sampled requests are rejected by ``submit_shipped``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpulab.disagg import deserialize_snapshot as jax_deserialize
from tpulab.disagg import serialize_snapshot as jax_serialize
from tpulab.disagg import prompt_digest as jax_digest
from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.models.transformer import (init_transformer_params,
                                       transformer_apply)
from tpulab_torch import chaos
from tpulab_torch.disagg import (KVShipper, WireFormatError,
                                 deserialize_snapshot, prompt_digest,
                                 serialize_snapshot)
from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF = 64, 32, 2, 2, 64
MARGIN_TOL = 1e-3
CFG = dict(n_heads=N_HEADS, n_layers=N_LAYERS, lanes=2, max_len=64,
           page_size=8, decode_block=4)
PLANS = {"ragged": dict(ragged=True), "split": dict(ragged=False)}
PROMPTS = {n: np.random.default_rng(n).integers(0, VOCAB, (n,), np.int32)
           for n in (5, 12, 17)}
STEPS = 8


@pytest.fixture(scope="module")
def lm():
    pj = init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                 seed=7, ffn="swiglu", tie_embeddings=False)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 "cpu", n_heads=N_HEADS)


def _device():
    return dict(temperature=0.8, seed=1234, device=True)


@pytest.fixture(scope="module")
def unified(lm):
    """tpulab's unified batcher (its CPU default, the split dispatch):
    greedy and device-sampled streams of every prompt."""
    ref = JaxBatcher(lm[0], compute_dtype=jnp.float32, **CFG)
    try:
        return {(n, mode): [int(t) for t in ref.submit(
                    p, STEPS, sampling=(JaxSampling(**_device())
                                        if mode == "device" else None)
                ).result(timeout=300)]
                for n, p in PROMPTS.items() for mode in ("greedy", "device")}
    finally:
        ref.shutdown()


def _same(pj, prompt, want, got, greedy):
    assert len(got) == len(want)
    if got == want:
        return
    assert greedy, (want, got)
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    seq = np.concatenate([prompt, np.asarray(want[:i], np.int32)])[None]
    logits = np.asarray(transformer_apply(
        pj, {"tokens": jnp.asarray(seq)}, n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=jnp.float32)["logits"])[0, -1]
    top2 = np.sort(logits)[-2:]
    assert float(top2[1] - top2[0]) < MARGIN_TOL, (i, want, got)


def _batcher(model, plan="ragged", **kw):
    kw.setdefault("kv_offload", 32 << 20)
    return ContinuousBatcher(model, compute_dtype=torch.float32,
                             device="cpu", **CFG, **PLANS[plan], **kw)


def _handoff(bp, bd, prompt, sampling=None, corrupt=None):
    """prefill -> export -> import -> submit_shipped; returns the decode
    side's stream and its shipper."""
    dig = prompt_digest(prompt)
    fut = bp.submit(prompt, 1, export_digest=dig,
                    sampling=SamplingParams(**sampling) if sampling else None)
    first = fut.result(timeout=300)[0]
    blob = KVShipper(bp.kv_offload).export(
        getattr(fut, "_tpulab_kv_export", None), digest=dig,
        first_token=first)
    if corrupt is not None and blob is not None:
        blob = corrupt(blob)
    in_sh = KVShipper(bd.kv_offload)
    ship = in_sh.import_shipment(blob) if blob is not None else None
    f2 = bd.submit_shipped(
        prompt, STEPS, first, ship.handle if ship is not None else None,
        sampling=SamplingParams(**sampling) if sampling else None)
    return [int(t) for t in f2.result(timeout=300)], in_sh


# -- the wire format -------------------------------------------------------------
def _payload(dtype):
    data = np.random.default_rng(0).standard_normal(
        (2, 3, 2, 4, 2, 8)).astype(np.float32)
    if dtype == "float32":
        return data, torch.from_numpy(data.copy())
    bf = data.astype(ml_dtypes.bfloat16)
    return bf, torch.from_numpy(bf.view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_blob_is_tpulabs_byte_for_byte(dtype):
    arr, ten = _payload(dtype)
    dig = jax_digest([1, 2, 3])
    assert prompt_digest([1, 2, 3]) == dig
    kw = dict(digest=dig, length=11, page_size=4, first_token=42)
    ours, theirs = serialize_snapshot(ten, **kw), jax_serialize(arr, **kw)
    assert ours == theirs
    got, hdr = deserialize_snapshot(theirs)           # we read theirs
    assert got.dtype == ten.dtype and tuple(got.shape) == arr.shape
    assert torch.equal(got.view(torch.uint8), ten.view(torch.uint8))
    assert hdr["length"] == 11 and hdr["page_size"] == 4
    assert hdr["first_token"] == 42 and hdr["digest"] == dig
    back, hdr2 = jax_deserialize(ours)                 # they read ours
    assert back.dtype == arr.dtype
    assert back.tobytes() == arr.tobytes() and hdr2["digest"] == dig


def _flip_last(blob):
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    return bytes(bad)


@pytest.mark.parametrize("mangle,match", [
    pytest.param(lambda b: b"NOPE" + b[4:], "magic", id="magic"),
    pytest.param(lambda b: b[:4] + b"\x63\x00" + b[6:], "version",
                 id="version"),
    pytest.param(_flip_last, "corrupt", id="crc"),
    pytest.param(lambda b: b[:len(b) // 2], "payload size", id="truncated"),
    pytest.param(lambda b: b[:12], "truncated", id="header"),
])
def test_wire_rejects(mangle, match):
    blob = serialize_snapshot(torch.zeros(1, 1, 2, 4, 2, 8),
                              digest=b"\x00" * 16, length=3, page_size=4,
                              first_token=0)
    deserialize_snapshot(blob)
    with pytest.raises(WireFormatError, match=match):
        deserialize_snapshot(mangle(blob))


# -- shipping --------------------------------------------------------------------
@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("mode", ["greedy", "device"])
def test_shipped_stream_matches_unified_tpulab(lm, unified, plan, mode):
    """Three handoffs through one decode batcher: zero prefill there, one
    restore per shipment, and the unified stream."""
    pj, model = lm
    bp, bd = _batcher(model, plan), _batcher(model, plan)
    got = {}
    try:
        for n, p in PROMPTS.items():
            got[n], in_sh = _handoff(
                bp, bd, p, sampling=_device() if mode == "device" else None)
            assert in_sh.imports == 1 and in_sh.import_failures == 0
        assert bd.prompt_fills == 0 and bd.prefill_dispatches == 0
        assert bp.prompt_fills == len(PROMPTS)
        assert bd.kv_offload.swap_ins == len(PROMPTS)
        assert len(bp.kv_offload.store) == len(bd.kv_offload.store) == 0
    finally:
        bp.shutdown()
        bd.shutdown()
    for n, p in PROMPTS.items():
        _same(pj, p, unified[(n, mode)], got[n], mode == "greedy")
    for cb in (bp, bd):
        assert cb.pool.free_pages == cb.pool.n_pages - 1


@pytest.mark.parametrize("how", ["chaos_export", "chaos_import", "corrupt",
                                 "geometry"])
def test_lost_shipment_degrades_to_local_prefill(lm, unified, how):
    pj, model = lm
    p = PROMPTS[12]
    bp = _batcher(model)
    if how == "geometry":    # a decode replica with another page size
        bd = ContinuousBatcher(model, compute_dtype=torch.float32,
                               device="cpu", kv_offload=32 << 20,
                               **dict(CFG, page_size=16))
    else:
        bd = _batcher(model)
    spec = {"chaos_export": "disagg.ship=error+1",
            "chaos_import": "disagg.ship=drop@1+1"}.get(how)
    corrupt = _flip_last if how == "corrupt" else None
    try:
        if spec:
            with chaos.inject(spec) as sched:
                got, in_sh = _handoff(bp, bd, p, _device(), corrupt)
                assert sched.fired("disagg.ship") == 1
        else:
            got, in_sh = _handoff(bp, bd, p, _device(), corrupt)
        assert in_sh.imports == 0
        assert bd.prompt_fills == 1            # the local prefill
        assert bd.kv_offload.swap_ins == 0
        assert len(bd.kv_offload.store) == 0
    finally:
        bp.shutdown()
        bd.shutdown()
    assert got == unified[(12, "device")]
    assert bd.pool.free_pages == bd.pool.n_pages - 1


def test_submit_shipped_rejects_host_sampled_and_bad_inputs(lm):
    bd = _batcher(lm[1])
    try:
        p = np.arange(4, dtype=np.int32)
        with pytest.raises(ValueError, match="host"):
            bd.submit_shipped(p, 4, 1, None,
                              sampling=SamplingParams(temperature=0.5))
        with pytest.raises(ValueError, match="first token"):
            bd.submit_shipped(p, 4, VOCAB, None)
        with pytest.raises(ValueError, match="empty"):
            bd.submit_shipped([], 4, 1, None)
        seen = []
        # steps == 1: the shipped first token IS the whole request
        assert bd.submit_shipped(p, 1, 7, None, on_token=lambda t, i:
                                 seen.append((t, i))).result(30) == [7]
        assert seen == [(7, 0)]
    finally:
        bd.shutdown()
    nb = _batcher(lm[1], kv_offload=None)
    try:
        with pytest.raises(ValueError, match="kv_offload"):
            nb.submit_shipped(p, 4, 1, object())
    finally:
        nb.shutdown()


def test_export_fences_write_behind_and_pops(lm):
    bp = _batcher(lm[1])
    try:
        p = PROMPTS[12]
        dig = prompt_digest(p)
        fut = bp.submit(p, 1, export_digest=dig)
        first = fut.result(timeout=300)[0]
        sh = KVShipper(bp.kv_offload)
        blob = sh.export(fut._tpulab_kv_export, digest=dig,
                         first_token=first)
        assert blob is not None and sh.exports == 1
        snap, hdr = deserialize_snapshot(blob)
        assert hdr["length"] == len(p) and hdr["first_token"] == first
        assert snap.shape[1] == (len(p) + 7) // 8          # pages covered
        assert len(bp.kv_offload.store) == 0               # popped
        assert sh.export(None, digest=dig, first_token=first) is None
        assert sh.export_failures == 1
    finally:
        bp.shutdown()
