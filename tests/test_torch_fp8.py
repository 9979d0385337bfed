"""fp8 (e4m3) KV pages on the port, held against tpulab on the CPU.

- ``to_kv_dtype`` is tpulab's ``x.astype(float8_e4m3fn)`` (ml_dtypes:
  round to nearest even, NaN past 464) bit for bit over every bf16
  pattern and the f32 specials.
- The ragged and paged plain versions over e4m3 pools agree with
  tpulab's Pallas kernels in interpret mode (f32 2e-5: summation order;
  bf16 2e-2: output rounding, as in the bf16 tests of those files).
- One decode step over identical e4m3 pool bytes gives logits within
  1e-5 of tpulab's (f32; both upcast the same bytes exactly).
- A prefill writes the pool bytes tpulab writes; where the two f32
  pre-cast values straddle a rounding midpoint the code may differ by
  one, and the test checks that this is the only way they differ.
- ``ContinuousBatcher(kv_dtype=float8_e4m3fn)`` at f32 compute (the
  geometry of tpulab's ``test_kv_cache_quantization_fp8``) gives
  tpulab's greedy and device-sampled streams under both plans, with the
  host KV tier (a preempted lane restored) and, within the port, with
  speculation; the pool is a quarter of the f32 pool's bytes.
- Unported page dtypes raise ``NotImplementedError``; a conflicting pool
  raises tpulab's ``ValueError``.
- The host tier round trip of an e4m3 pool is bit-exact, and an e4m3
  wire blob is byte-identical to tpulab's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpulab.disagg import wire as jwire
from tpulab.engine import paged as jp
from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.models.transformer import init_transformer_params
from tpulab.ops.paged_attention import paged_decode_attention as tpu_pda
from tpulab.ops.ragged_attention import ragged_paged_attention as tpu_rpa
from tpulab_torch.disagg import wire
from tpulab_torch.engine import paged as tp
from tpulab_torch.engine.paged import (ContinuousBatcher, PagedKVPool,
                                       SamplingParams, to_kv_dtype)
from tpulab_torch.kvcache import KVOffloadManager
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.ops.paged_attention import paged_decode_attention
from tpulab_torch.ops.ragged_attention import ragged_paged_attention

torch.set_num_threads(2)

E4M3 = torch.float8_e4m3fn
# tpulab's test_kv_cache_quantization_fp8 geometry
VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF = 64, 32, 2, 2, 64
CFG = dict(n_heads=N_HEADS, n_layers=N_LAYERS, lanes=2, max_len=32,
           page_size=8)
PLANS = {"ragged": dict(ragged=True), "split": dict(ragged=False)}
JAX_PLANS = {"ragged": dict(use_kernel=False, ragged=True),
             "split": dict(use_kernel=False)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _e4m3_pool(arr: np.ndarray) -> torch.Tensor:
    """tpulab's cast of ``arr``, carried over as bytes."""
    raw = _jbits(jnp.asarray(arr).astype(jnp.float8_e4m3fn))
    return torch.from_numpy(raw.copy()).view(E4M3)


# -- the cast ---------------------------------------------------------------
def test_to_kv_dtype_matches_jnp_over_every_bf16_pattern():
    pats = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(pats.view(np.int16)).view(torch.bfloat16)
    want = _jbits(jnp.asarray(pats.view(ml_dtypes.bfloat16)).astype(
        jnp.float8_e4m3fn))
    got = _bits(to_kv_dtype(x, E4M3))
    assert np.array_equal(got, want), int((got != want).sum())


def test_to_kv_dtype_matches_jnp_at_f32_specials():
    tiny = np.float32(2.0 ** -9)           # e4m3's least subnormal
    specials = np.array(
        [0.0, -0.0, 448.0, -448.0, 456.0, 463.99997, 464.0, -464.0,
         464.00003, 465.0, -465.0, 466.0, -466.0, 1e4, -1e30, np.inf,
         -np.inf, np.nan, -np.nan, tiny, -tiny, tiny / 2, tiny * 0.5001,
         tiny * 1.5, 3 * tiny, 2.0 ** -6, 2.0 ** -6 * 0.999, 1e-30],
        np.float32)
    noise = np.random.default_rng(0).normal(0, 100, 1 << 16).astype(
        np.float32)
    for x in (specials, noise):
        want = _jbits(jnp.asarray(x).astype(jnp.float8_e4m3fn))
        got = _bits(to_kv_dtype(torch.from_numpy(x), E4M3))
        assert np.array_equal(got, want), x[got != want]


def test_to_kv_dtype_other_dtypes_are_a_plain_cast():
    x = torch.randn(64)
    assert torch.equal(to_kv_dtype(x, torch.bfloat16), x.to(torch.bfloat16))
    assert to_kv_dtype(x, torch.float32) is x


# -- the kernels' plain versions --------------------------------------------
def _attn_inputs(seed, b, m, hq, hkv, d, s, mp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, m, hq, d)).astype(np.float32)
    pool = rng.standard_normal((b * mp + 1, 2, s, hkv, d)).astype(np.float32)
    tables = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    return q, pool, tables


@pytest.mark.parametrize("q_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [
    ([1, 1, 1, 0], [17, 8, 3, 0]),        # decode, one lane idle
    ([4, 8, 5, 3], [12, 16, 21, 3]),      # verify / chunk rows
])
def test_ragged_plain_version_over_e4m3_pool(q_dt, lens):
    q, pool, tables = _attn_inputs(1, 4, 8, 4, 2, 64, 8, 4)
    q_lens, kv_lens = lens
    jq = jnp.asarray(q).astype(getattr(jnp, q_dt))
    want = np.asarray(tpu_rpa(
        jq, jnp.asarray(pool).astype(jnp.float8_e4m3fn), jnp.asarray(tables),
        jnp.asarray(q_lens, jnp.int32), jnp.asarray(kv_lens, jnp.int32)),
        np.float32)
    got = ragged_paged_attention(
        torch.from_numpy(q).to(getattr(torch, q_dt)), _e4m3_pool(pool),
        torch.from_numpy(tables), torch.tensor(q_lens, dtype=torch.int32),
        torch.tensor(kv_lens, dtype=torch.int32))
    assert got.dtype == getattr(torch, q_dt)
    tol = 2e-5 if q_dt == "float32" else 2e-2
    for lane, n in enumerate(q_lens):
        np.testing.assert_allclose(got[lane, :n].float().numpy(),
                                   want[lane, :n], rtol=tol, atol=tol)


@pytest.mark.parametrize("q_dt", ["float32", "bfloat16"])
def test_paged_plain_version_over_e4m3_pool(q_dt):
    """Lengths on page boundaries (7, 8: a page's last slot and the next
    page's first) and a dead-page tail planted with 0x7F (NaN) past each
    lane's inclusive position."""
    q, pool, tables = _attn_inputs(2, 4, 1, 4, 2, 64, 8, 4)
    lengths = [7, 8, 20, 0]
    pt = _e4m3_pool(pool)
    jpool = _jbits(jnp.asarray(pool).astype(jnp.float8_e4m3fn)).copy()
    for lane, n in enumerate(lengths):     # NaN past the live positions
        for pos in range(n + 1, 4 * 8):
            page = tables[lane, pos // 8]
            jpool[page, :, pos % 8] = 0x7F
            pt.view(torch.uint8)[page, :, pos % 8] = 0x7F
    jq = jnp.asarray(q[:, 0]).astype(getattr(jnp, q_dt))
    want = np.asarray(tpu_pda(jq, jnp.asarray(jpool.view(
        ml_dtypes.float8_e4m3fn)), jnp.asarray(tables),
        jnp.asarray(lengths, jnp.int32)), np.float32)
    got = paged_decode_attention(
        torch.from_numpy(q[:, 0]).to(getattr(torch, q_dt)), pt,
        torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32))
    assert torch.isfinite(got).all()
    tol = 2e-5 if q_dt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# -- the paged programs -------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    p = init_transformer_params(vocab=VOCAB, d_model=D_MODEL,
                                n_heads=N_HEADS, n_layers=N_LAYERS,
                                d_ff=D_FF)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu", n_heads=N_HEADS)


def test_decode_step_over_identical_e4m3_bytes(lm):
    """tpulab's numerics check (one decode tick, fp8 vs f32 pool): here
    the port and tpulab read the SAME e4m3 bytes, so the logits agree
    within 1e-5 (f32 summation order) and the row each writes is the
    same bytes."""
    pj, model = lm
    rng = np.random.default_rng(0)
    kv32 = rng.uniform(-1, 1, (2, 4, 2, 8, 2, 16)).astype(np.float32)
    kv_j = jnp.asarray(kv32).astype(jnp.float8_e4m3fn)
    kv_t = _e4m3_pool(kv32)
    args = ([[1, 2]], [12], [3], [True])
    lj, kv_j = jp.paged_decode_step(
        pj, kv_j, *(jnp.asarray(a) for a in args), n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=jnp.float32)[:2]
    lt = tp.paged_decode_step(
        model.params, kv_t, *(torch.tensor(a) for a in args),
        n_heads=N_HEADS, n_layers=N_LAYERS, compute_dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(_bits(kv_t)[:, 1:], _jbits(kv_j)[:, 1:])


def test_prefill_writes_tpulab_pool_bytes(lm):
    """A 13-token prefill into e4m3 pages: the bytes equal tpulab's, or
    differ by one code where the two f32 pre-cast values (K/V from each
    side's own forward) lie on either side of that pair's midpoint."""
    pj, model = lm
    shape = (N_LAYERS, 3, 2, 8, N_HEADS, D_MODEL // N_HEADS)
    table = np.array([1, 2], np.int32)
    prompt = np.zeros((1, 16), np.int64)
    prompt[0, :13] = np.random.default_rng(3).integers(0, VOCAB, 13)
    _, kv_j = jp.paged_prefill(
        pj, jnp.zeros(shape, jnp.float8_e4m3fn), jnp.asarray(table),
        jnp.asarray(prompt, jnp.int32), jnp.int32(13), n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=jnp.float32)
    kv_t = torch.zeros(shape, dtype=E4M3)
    tp.paged_prefill(model.params, kv_t, torch.from_numpy(table),
                     torch.from_numpy(prompt), 13, n_heads=N_HEADS,
                     n_layers=N_LAYERS, compute_dtype=torch.float32)
    want, got = _jbits(kv_j)[:, 1:], _bits(kv_t)[:, 1:]
    diff = np.argwhere(want != got)
    if len(diff):
        from tpulab.models.transformer import transformer_forward_collect_kv
        _, kvs = transformer_forward_collect_kv(
            pj, jnp.asarray(prompt[:, :13], jnp.int32), n_heads=N_HEADS,
            n_layers=N_LAYERS, compute_dtype=jnp.float32)
        _, tkvs = tp.transformer_forward_collect_kv(
            model.params, torch.from_numpy(prompt[:, :13]), n_heads=N_HEADS,
            n_layers=N_LAYERS, compute_dtype=torch.float32)
        dec = want.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
        dec_t = got.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
        for layer, page, kv, slot, h, d in diff:
            pos = page * 8 + slot
            a = float(np.asarray(kvs[layer][kv])[0, pos, h, d])
            b = float(tkvs[layer][kv][0, pos, h, d])
            mid = (dec[layer, page, kv, slot, h, d]
                   + dec_t[layer, page, kv, slot, h, d]) / 2
            assert abs(int(want[layer, page, kv, slot, h, d])
                       - int(got[layer, page, kv, slot, h, d])) == 1
            assert min(a, b) <= mid <= max(a, b), (a, b, mid)
    print(f"e4m3 prefill: {len(diff)} of {want.size} pool bytes differ "
          "from tpulab's (each a midpoint straddle)")


# -- the batcher --------------------------------------------------------------
def _serve(cb, sampling_cls):
    rng = np.random.default_rng(2)
    p6 = rng.integers(0, VOCAB, (6,), np.int32)
    p13 = rng.integers(0, VOCAB, (13,), np.int32)
    return {
        "greedy": list(cb.submit(p6, 5).result(timeout=300)),
        "long": list(cb.submit(p13, 12).result(timeout=300)),
        "device": list(cb.submit(p13, 8, sampling=sampling_cls(
            temperature=0.8, seed=42, device=True)).result(timeout=300)),
    }


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_e4m3_batcher_matches_tpulab(lm, plan):
    pj, model = lm
    ref = JaxBatcher(pj, compute_dtype=jnp.float32,
                     kv_dtype=jnp.float8_e4m3fn, **CFG, **JAX_PLANS[plan])
    try:
        want = _serve(ref, JaxSampling)
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           kv_dtype=E4M3, **CFG, **PLANS[plan])
    cb32 = ContinuousBatcher(model, compute_dtype=torch.float32,
                             device="cpu", **CFG, **PLANS[plan])
    try:
        assert cb.pool.dtype == E4M3 and cb.pool.kv.dtype == E4M3
        assert cb.pool.hbm_bytes * 4 == cb32.pool.hbm_bytes
        got = _serve(cb, SamplingParams)
    finally:
        cb.shutdown()
        cb32.shutdown()
    assert got == want


def test_e4m3_preempt_resume_from_host_tier_matches_tpulab(lm):
    """A victim preempted at its 4th token (from its own on_token) and
    restored from the host tier: the same streams as tpulab's fp8
    batcher with its tier, no re-prefill, every page home."""
    pj, model = lm
    low_p = np.random.default_rng(21).integers(0, VOCAB, (12,), np.int32)
    hi_p = np.random.default_rng(22).integers(0, VOCAB, (5,), np.int32)
    cfg = dict(CFG, lanes=1, decode_block=2)

    def run(cb):
        late = {}

        def arrive(tok, i):
            if i == 3 and "f" not in late:
                late["f"] = cb.submit(hi_p, 4, priority=10)

        low = [int(t) for t in cb.submit(low_p, 12, on_token=arrive)
               .result(timeout=300)]
        return low, [int(t) for t in late["f"].result(timeout=300)]

    ref = JaxBatcher(pj, compute_dtype=jnp.float32, kv_offload=8 << 20,
                     kv_dtype=jnp.float8_e4m3fn, use_kernel=False,
                     ragged=True, **cfg)
    try:
        want = run(ref)
        assert ref.kv_offload.swap_ins == 1
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           kv_offload=8 << 20, kv_dtype=E4M3, **cfg)
    try:
        got = run(cb)
        mgr = cb.kv_offload
        assert (cb.preemptions, mgr.swap_outs, mgr.swap_ins) == (1, 1, 1)
        assert mgr.swap_failures == mgr.swap_drops == 0
        assert cb.prompt_fills == 2
        free, n_pages = cb.pool.free_pages, cb.pool.n_pages
    finally:
        cb.shutdown()
    assert got == want
    assert free == n_pages - 1


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_e4m3_speculative_equals_plain_blocks(lm, plan):
    """Within the port: the target as its own draft over an e4m3 pool
    gives the stream of plain K-blocks (greedy and device-sampled)."""
    _, model = lm
    streams = {}
    for mode in ("plain", "spec"):
        extra = (dict(draft_params=model, draft_n_layers=N_LAYERS)
                 if mode == "spec" else {})
        cb = ContinuousBatcher(model, compute_dtype=torch.float32,
                               device="cpu", kv_dtype=E4M3, **CFG,
                               **PLANS[plan], **extra)
        try:
            streams[mode] = _serve(cb, SamplingParams)
            if mode == "spec":
                assert cb.spec_dispatches > 0
        finally:
            cb.shutdown()
    assert streams["spec"] == streams["plain"]


# -- refusals -------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float8_e5m2, torch.float16])
def test_unported_page_dtypes_raise(lm, dtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatcher(lm[1], compute_dtype=torch.float32, device="cpu",
                          kv_dtype=dtype, **CFG)


def test_conflicting_pool_raises(lm):
    pool = PagedKVPool(9, 8, N_LAYERS, N_HEADS, D_MODEL // N_HEADS,
                       torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="kv_dtype=float8_e4m3fn conflicts "
                       "with the provided pool's dtype bfloat16"):
        ContinuousBatcher(lm[1], pool=pool, compute_dtype=torch.float32,
                          kv_dtype=E4M3, **CFG)


# -- host tier and wire -----------------------------------------------------------
def _filled_pool():
    pool = PagedKVPool(10, 4, 2, 2, 8, E4M3, "cpu")
    bits = np.random.default_rng(5).integers(0, 256, tuple(pool.kv.shape),
                                             dtype=np.uint8)
    pool.kv.view(torch.uint8).copy_(torch.from_numpy(bits))
    return pool


def test_e4m3_host_tier_round_trip_bit_exact():
    """Pages -> host -> OTHER pages restores the bytes (NaN codes
    included: the pool holds every byte value) and writes no other
    page."""
    pool = _filled_pool()
    mgr = KVOffloadManager(pool, 8 << 20)
    try:
        src = [pool.allocate_page() for _ in range(3)]
        snap = _bits(pool.kv[:, src].clone())
        h = mgr.swap_out(src, length=11, kv=pool.kv)
        assert h is not None and h.wait(30)
        pool.release_pages(src)
        dst = [pool.allocate_page() for _ in range(6)][3:]
        before = _bits(pool.kv.clone())
        assert mgr.restore(h, dst, pool.kv) is pool.kv
        after = _bits(pool.kv)
        assert np.array_equal(after[:, dst], snap)
        rest = [p for p in range(10) if p not in dst]
        assert np.array_equal(after[:, rest], before[:, rest])
        assert mgr.swap_out_bytes == 3 * mgr.page_nbytes
        assert mgr.page_nbytes == 2 * 2 * 4 * 2 * 8     # one byte a value
    finally:
        mgr.close()


def test_e4m3_wire_blob_matches_tpulab():
    pool = _filled_pool()
    snap = pool.kv[:, [3, 7]].clone()
    kw = dict(digest=bytes(range(16)), length=6, page_size=4, first_token=9)
    blob = wire.serialize_snapshot(snap, **kw)
    want = jwire.serialize_snapshot(
        _bits(snap).view(ml_dtypes.float8_e4m3fn), **kw)
    assert blob == want
    back, header = wire.deserialize_snapshot(blob)
    assert back.dtype == E4M3 and header["dtype"] == "float8_e4m3fn"
    assert np.array_equal(_bits(back), _bits(snap))
