"""float16 compute and float16 / float8_e5m2 KV pages on the port, held
against tpulab on the CPU.

- ``to_kv_dtype`` to f16 and e5m2 is tpulab's ``x.astype(...)`` (round
  to nearest even, inf past the largest finite value) bit for bit over
  every bf16 and every f16 pattern, the f32 specials and random f32 bit
  patterns (NaN payloads among them): a plain ``.to`` for every number,
  and jnp's NaN codes (f16: the sign and the payload's top bits, quieted;
  e5m2: 0x7E under the sign from f32, 0x7F from bf16 or f16), which the
  card's ``.to`` does not give (``chip_smoke.py`` phase 18 (b)); e4m3
  from f16 (f16 compute over e4m3 pages) likewise.
- The ragged and paged plain versions over f16 and e5m2 pools with f32,
  bf16 and f16 q agree with tpulab's Pallas kernels in interpret mode
  (f32 2e-5: summation order; bf16 2e-2: output rounding, as in
  ``test_torch_fp8.py``; f16 2e-3: output rounding, one f16 ulp is 2^-10
  relative, twice that covers both sides' roundings of values near 1).
  The paged case plants NaN in every dead position.
- The flash plain version at f16 against tpulab's ``flash_attention`` in
  interpret mode (2e-3, the same reason).
- The body table (:func:`ragged_body`, :func:`flash_body`) as a pure
  function of (q dtype, page dtype, D), every cell.
- ``ContinuousBatcher`` streams (greedy, long, device-sampled) equal
  tpulab's under both plans: f32 compute over f16 pages, over e5m2
  pages, and f16 compute with its default (f16) pages.
- The host tier round trip of f16 and e5m2 pools is bit-exact, and their
  wire blobs are byte-identical to tpulab's.
- A combination the kernels are not built for (D 0, a float64 q, int8
  pages) is refused by :func:`check_built`, and a page dtype no kernel
  reads by the batcher.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpulab.disagg import wire as jwire
from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.models.transformer import init_transformer_params
from tpulab.ops.flash_attention import flash_attention as tpu_flash
from tpulab.ops.paged_attention import paged_decode_attention as tpu_pda
from tpulab.ops.ragged_attention import ragged_paged_attention as tpu_rpa
from tpulab_torch.disagg import wire
from tpulab_torch.engine.paged import (ContinuousBatcher, PagedKVPool,
                                       SamplingParams, to_kv_dtype)
from tpulab_torch.kvcache import KVOffloadManager
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.ops.flash_attention import flash_attention, flash_body
from tpulab_torch.ops.paged_attention import paged_decode_attention
from tpulab_torch.ops.ragged_attention import (check_built,
                                               ragged_body,
                                               ragged_paged_attention)

torch.set_num_threads(2)

F16, E5M2 = torch.float16, torch.float8_e5m2
PAGES = {"float16": (F16, jnp.float16), "float8_e5m2": (E5M2,
                                                        jnp.float8_e5m2)}
Q_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}
# tpulab's test_kv_cache_quantization_fp8 geometry (test_torch_fp8.py's lm)
VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF = 64, 32, 2, 2, 64
CFG = dict(n_heads=N_HEADS, n_layers=N_LAYERS, lanes=2, max_len=32,
           page_size=8)
PLANS = {"ragged": dict(ragged=True), "split": dict(ragged=False)}
JAX_PLANS = {"ragged": dict(use_kernel=False, ragged=True),
             "split": dict(use_kernel=False)}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a tensor (uint8 for fp8, uint16 for 16-bit)."""
    view = torch.uint8 if t.element_size() == 1 else torch.int16
    return t.contiguous().view(view).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.itemsize == 1 else np.int16)


def _pool(arr: np.ndarray, name: str) -> torch.Tensor:
    """tpulab's cast of ``arr`` to page dtype ``name``, carried over as
    bytes."""
    tdt, jdt = PAGES[name]
    raw = _jbits(jnp.asarray(arr).astype(jdt)).copy()
    return torch.from_numpy(raw).view(tdt)


# -- the cast ---------------------------------------------------------------
def _sources():
    pats = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    specials = np.array(
        [0.0, -0.0, 57344.0, -57344.0, 61439.0, 61440.0, 61441.0, -61441.0,
         65504.0, 65519.0, 65520.0, -65520.0, 1e6, -1e30, np.inf, -np.inf,
         np.nan, -np.nan, 2.0 ** -16, 2.0 ** -17, 2.0 ** -17 * 1.0001,
         2.0 ** -24, 2.0 ** -25, 2.0 ** -25 * 1.001, 2.0 ** -14, 1e-30,
         1.5 * 2.0 ** -16, 3.0 * 2.0 ** -17], np.float32)
    noise = (np.random.default_rng(0).standard_normal(1 << 16)
             * 10.0 ** np.random.default_rng(1).uniform(-8, 6, 1 << 16))
    return {
        "bf16_patterns": (pats.view(ml_dtypes.bfloat16),
                          torch.from_numpy(pats.view(np.int16)).view(
                              torch.bfloat16)),
        "f16_patterns": (pats.view(np.float16),
                         torch.from_numpy(pats.view(np.float16).copy())),
        "f32_specials": (np.concatenate([
            specials, noise.astype(np.float32),
            np.random.default_rng(2).integers(
                0, 1 << 32, 1 << 16, dtype=np.uint64).astype(
                    np.uint32).view(np.float32)]), None),
    }


@pytest.mark.parametrize("source", ["bf16_patterns", "f16_patterns",
                                    "f32_specials"])
@pytest.mark.parametrize("name", sorted(PAGES))
def test_to_kv_dtype_matches_jnp(name, source):
    arr, t = _sources()[source]
    if t is None:
        t = torch.from_numpy(arr)
    tdt, jdt = PAGES[name]
    want = _jbits(jnp.asarray(arr).astype(jdt))
    got = _bits(to_kv_dtype(t, tdt))
    assert np.array_equal(got, want), int((got != want).sum())
    plain = _bits(t.to(tdt))
    num = ~torch.isnan(t).numpy()
    assert np.array_equal(got[num], plain[num])     # numbers: a plain .to


@pytest.mark.parametrize("source", ["f16_patterns", "f32_specials"])
def test_to_kv_dtype_e4m3_matches_jnp(source):
    """e4m3 pages under f16 compute: every f16 pattern (and the f32
    specials) to jnp's e4m3 bits."""
    arr, t = _sources()[source]
    if t is None:
        t = torch.from_numpy(arr)
    want = _jbits(jnp.asarray(arr).astype(jnp.float8_e4m3fn))
    got = _bits(to_kv_dtype(t, torch.float8_e4m3fn))
    assert np.array_equal(got, want), int((got != want).sum())


# -- the kernels' plain versions --------------------------------------------
def _attn_inputs(seed, b, m, hq, hkv, d, s, mp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, m, hq, d)).astype(np.float32)
    pool = rng.standard_normal((b * mp + 1, 2, s, hkv, d)).astype(np.float32)
    tables = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    return q, pool, tables


@pytest.mark.parametrize("q_dt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("page", sorted(PAGES))
@pytest.mark.parametrize("lens", [
    ([1, 1, 1, 0], [17, 8, 3, 0]),        # decode, one lane idle
    ([4, 8, 5, 3], [12, 16, 21, 3]),      # verify / chunk rows
])
def test_ragged_plain_version(q_dt, page, lens):
    q, pool, tables = _attn_inputs(1, 4, 8, 4, 2, 64, 8, 4)
    q_lens, kv_lens = lens
    jq = jnp.asarray(q).astype(getattr(jnp, q_dt))
    want = np.asarray(tpu_rpa(
        jq, jnp.asarray(pool).astype(PAGES[page][1]), jnp.asarray(tables),
        jnp.asarray(q_lens, jnp.int32), jnp.asarray(kv_lens, jnp.int32)),
        np.float32)
    got = ragged_paged_attention(
        torch.from_numpy(q).to(getattr(torch, q_dt)), _pool(pool, page),
        torch.from_numpy(tables), torch.tensor(q_lens, dtype=torch.int32),
        torch.tensor(kv_lens, dtype=torch.int32))
    assert got.dtype == getattr(torch, q_dt)
    tol = Q_TOL[q_dt]
    for lane, n in enumerate(q_lens):
        np.testing.assert_allclose(got[lane, :n].float().numpy(),
                                   want[lane, :n], rtol=tol, atol=tol)


#: a NaN of each page dtype: e5m2 0x7F, f16 0x7E00
_NAN_BITS = {"float8_e5m2": 0x7F, "float16": 0x7E00}


@pytest.mark.parametrize("q_dt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("page", sorted(PAGES))
def test_paged_plain_version(q_dt, page):
    """Lengths on page boundaries (7, 8) and a NaN in every position past
    each lane's inclusive one."""
    q, pool, tables = _attn_inputs(2, 4, 1, 4, 2, 64, 8, 4)
    lengths = [7, 8, 20, 0]
    pt = _pool(pool, page)
    raw = _bits(pt)                        # shares pt's memory
    for lane, n in enumerate(lengths):
        for pos in range(n + 1, 4 * 8):
            raw[tables[lane, pos // 8], :, pos % 8] = _NAN_BITS[page]
    jpool = raw.copy().view(np.float16 if page == "float16"
                            else ml_dtypes.float8_e5m2)
    jq = jnp.asarray(q[:, 0]).astype(getattr(jnp, q_dt))
    want = np.asarray(tpu_pda(jq, jnp.asarray(jpool), jnp.asarray(tables),
                              jnp.asarray(lengths, jnp.int32)), np.float32)
    got = paged_decode_attention(
        torch.from_numpy(q[:, 0]).to(getattr(torch, q_dt)), pt,
        torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32))
    assert torch.isfinite(got).all()
    tol = Q_TOL[q_dt]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_f16(causal):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
            for _ in range(3)]
    want = np.asarray(tpu_flash(*(jnp.asarray(a).astype(jnp.float16)
                                  for a in arrs), causal=causal,
                                block_q=64, block_k=64), np.float32)
    got = flash_attention(*(torch.from_numpy(a).to(F16) for a in arrs),
                          causal=causal, block_q=64, block_k=64)
    assert got.dtype == F16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3,
                               atol=2e-3)


# -- the body table ------------------------------------------------------------
_Q = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
_KV = {"f32": torch.float32, "bf16": torch.bfloat16, "e4m3":
       torch.float8_e4m3fn, "e5m2": E5M2, "f16": F16}
#: the body each (q, pages) cell runs at D 64 and 128 (D 256: always fma)
BODY_TABLE = {
    ("f32", "f32"): "fma", ("f32", "bf16"): "fma", ("f32", "e4m3"): "fma",
    ("f32", "e5m2"): "fma", ("f32", "f16"): "fma",
    ("bf16", "f32"): "fma", ("bf16", "bf16"): "wgmma",
    ("bf16", "e4m3"): "wgmma", ("bf16", "e5m2"): "wgmma",
    ("bf16", "f16"): "fma",
    ("f16", "f32"): "fma", ("f16", "bf16"): "fma", ("f16", "e4m3"): "wgmma",
    ("f16", "e5m2"): "wgmma", ("f16", "f16"): "wgmma",
}


@pytest.mark.parametrize("cell", sorted(BODY_TABLE))
def test_body_table(cell):
    q, kv = _Q[cell[0]], _KV[cell[1]]
    for d in (64, 128):
        assert ragged_body(q, kv, d) == BODY_TABLE[cell]
        assert ragged_body(q, kv, d) == ragged_body(q, kv, d)
    assert ragged_body(q, kv, 256) == BODY_TABLE[cell]
    assert ragged_body(q, kv, 32) == "fma"
    if cell[0] == cell[1]:                 # the flash kernel: one dtype
        assert flash_body(q, 128) == ("fma" if q == torch.float32
                                      else "wgmma")
        assert flash_body(q, 256) == flash_body(q, 128)
        assert flash_body(q, 32) == "fma"
    for d in (32, 64, 128, 256):
        check_built(q, kv, d)


@pytest.mark.parametrize("combo,exc", [
    ((torch.float16, F16, 0), ValueError),
    ((torch.float64, F16, 128), TypeError),
    ((torch.bfloat16, torch.int8, 128), TypeError)])
def test_unbuilt_combination_raises(combo, exc):
    with pytest.raises(exc, match="not built|kernels take"):
        check_built(*combo)


# -- the batcher --------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    p = init_transformer_params(vocab=VOCAB, d_model=D_MODEL,
                                n_heads=N_HEADS, n_layers=N_LAYERS,
                                d_ff=D_FF)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu", n_heads=N_HEADS)


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


#: (compute, pages) of each serve; pages None: the compute dtype's
SERVES = {"f32/f16": ("float32", "float16"),
          "f32/e5m2": ("float32", "float8_e5m2"),
          "f16/default": ("float16", None)}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("serve", sorted(SERVES))
def test_batcher_matches_tpulab(lm, serve, plan):
    pj, model = lm
    compute, page = SERVES[serve]
    ref = JaxBatcher(pj, compute_dtype=getattr(jnp, compute),
                     kv_dtype=page and getattr(jnp, page), **CFG,
                     **JAX_PLANS[plan])
    try:
        want = _serve(ref, JaxSampling)
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(model, compute_dtype=getattr(torch, compute),
                           device="cpu", kv_dtype=page and getattr(
                               torch, page), **CFG, **PLANS[plan])
    try:
        assert cb.pool.dtype == getattr(torch, page or compute)
        assert cb.pool.kv.dtype == cb.pool.dtype
        got = _serve(cb, SamplingParams)
    finally:
        cb.shutdown()
    assert got == want


def test_unread_page_dtype_raises(lm):
    with pytest.raises(NotImplementedError, match="no kernel reads"):
        ContinuousBatcher(lm[1], compute_dtype=torch.float32, device="cpu",
                          kv_dtype=torch.float64, **CFG)


# -- host tier and wire -----------------------------------------------------------
def _filled_pool(name):
    pool = PagedKVPool(10, 4, 2, 2, 8, PAGES[name][0], "cpu")
    bits = np.random.default_rng(5).integers(
        0, 256, tuple(pool.kv.shape) + (pool.kv.element_size(),),
        dtype=np.uint8)
    pool.kv.view(torch.uint8).copy_(torch.from_numpy(
        bits.reshape(pool.kv.view(torch.uint8).shape)))
    return pool


@pytest.mark.parametrize("name", sorted(PAGES))
def test_host_tier_round_trip_bit_exact(name):
    """Pages -> host -> OTHER pages restores the bytes (NaN and inf codes
    included: the pool holds random bytes) and writes no other page."""
    pool = _filled_pool(name)
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
        assert mgr.page_nbytes == 2 * 2 * 4 * 2 * 8 * pool.kv.element_size()
    finally:
        mgr.close()


@pytest.mark.parametrize("name", sorted(PAGES))
def test_wire_blob_matches_tpulab(name):
    pool = _filled_pool(name)
    snap = pool.kv[:, [3, 7]].clone()
    kw = dict(digest=bytes(range(16)), length=6, page_size=4, first_token=9)
    blob = wire.serialize_snapshot(snap, **kw)
    np_dt = np.float16 if name == "float16" else ml_dtypes.float8_e5m2
    want = jwire.serialize_snapshot(_bits(snap).view(np_dt), **kw)
    assert blob == want
    back, header = wire.deserialize_snapshot(blob)
    assert back.dtype == PAGES[name][0] and header["dtype"] == name
    assert np.array_equal(_bits(back), _bits(snap))
    jback, jheader = jwire.deserialize_snapshot(blob)
    assert jheader["dtype"] == name
    assert np.array_equal(_jbits(jback), _bits(snap))
