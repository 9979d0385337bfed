"""The tensor-core wide form of kernels 1 and 2 (``"wgmma-wide"``).

tpulab's ragged and flash kernels take any head dim
(``tpulab/ops/ragged_attention.py``, ``flash_attention.py``).  Past 256
the port runs the 16-bit pairs whose upcast to q's type is exact (bf16 q
over bf16, e4m3 or e5m2 pages; f16 q over f16, e4m3 or e5m2; kernel 2 in
bf16 or f16) on the tensor cores at every D that is a multiple of 16
(``tpulab_torch/ops/csrc/wide_wgmma.cuh``); f32, the mixed 16-bit pairs,
other head dims and all of kernel 3 stay on the wide fma form.  Here on
the CPU: which body each call takes, the split count as a function of
shapes, the shared-memory plan against a block's 232,448 bytes and
against the CUDA source's constants, and the plain versions of the new
dtype pairs against tpulab's Pallas kernels in interpret mode
(tolerances by the output dtype, as ``tests/test_torch_head_dims.py``
holds them).

The card's cases are marked ``cuda`` and skip without a card (``python
-m pytest --noconftest -m cuda tests/test_torch_wide_wgmma.py``; the
card's machine has no JAX, so the reference imports are optional).
There each new pair is held against its plain version at the card's
tolerance for the tensor-core bodies, ``CARD_TOL``: the kernel rounds P
to q's type before P V (2^-9 relative a weight in bf16, 2^-12 in f16),
which the plain version does not, and both round the output to q's type.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax.numpy as jnp

    from tpulab.ops.flash_attention import flash_attention as tpu_flash
    from tpulab.ops.ragged_attention import \
        ragged_paged_attention as tpu_rpa
except ImportError:
    jnp = None
from test_torch_head_dims import CARD_TOL, RA_LENS, TOL, _inputs, _pool, _q
from test_torch_head_dims_wide import CARD_LENS, _card, _card_close
from tpulab_torch.ops import ragged_attention as ra
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_body)
from tpulab_torch.ops.paged_attention import paged_form
from tpulab_torch.ops.ragged_attention import (
    FMA_WIDTH, KV_CODE, MAX_SPLITS, Q_CODE, WGMMA_PAGES, WGMMA_WIDE_ALIGN,
    WGMMA_WIDE_SMEM_LIMIT, body_form, ragged_body, ragged_paged_attention,
    ragged_paged_attention_reference, ragged_splits, wgmma_wide_plan)

torch.set_num_threads(2)

SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
         torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}
#: D past 256: multiples of 16 (272, a last chunk of 16 columns; 320;
#: DeepSeek-V4-Flash's 512; sarvam-105b's 576; 1024; 2048) and not (257,
#: 264, 325)
BODY_DIMS = (257, 264, 272, 320, 325, 384, 512, 576, 1024, 2048)
#: the pairs the tensor-core wide form takes
TC_PAIRS = [(q, kv) for q in ("bfloat16", "float16")
            for kv in (q, "float8_e4m3fn", "float8_e5m2")]
CSRC = (Path(__file__).resolve().parents[1] / "tpulab_torch" / "ops"
        / "csrc" / "wide_wgmma.cuh")


# --------------------------------------------------------- the host rules
@pytest.mark.parametrize("d", BODY_DIMS)
@pytest.mark.parametrize("kv_dt", list(KV_CODE), ids=lambda t: SHORT[t])
@pytest.mark.parametrize("q_dt", list(Q_CODE), ids=lambda t: SHORT[t])
def test_body_choice_past_256(q_dt, kv_dt, d):
    """``"wgmma-wide"`` exactly for the 16-bit, exact-upcast pairs at D
    past 256 with D % 16 == 0; ``"fma-wide"`` for f32, the mixed 16-bit
    pairs and other D; kernel 3 keeps ``"fma-wide"``."""
    tc = kv_dt in WGMMA_PAGES.get(q_dt, ()) and d % WGMMA_WIDE_ALIGN == 0
    want = "wgmma-wide" if tc else "fma-wide"
    assert ragged_body(q_dt, kv_dt, d) == want
    if q_dt == kv_dt:
        assert flash_body(q_dt, d) == want
    assert paged_form(d) == "fma-wide"
    assert body_form(want, q_dt) == (
        f"wgmma-wide {SHORT[q_dt]}" if tc else "fma-wide")


@pytest.mark.parametrize("d", (64, 96, 128, 160, 256))
def test_body_choice_to_256_is_unchanged(d):
    """At D up to 256 the wide forms are never chosen."""
    for q in Q_CODE:
        for kv in KV_CODE:
            assert ragged_body(q, kv, d) in ("wgmma", "fma")
        assert flash_body(q, d) in ("wgmma", "fma")


def test_wgmma_wide_splits_are_a_function_of_shapes():
    """Split-KV where the (64-row tile, column block, KV head, lane)
    blocks do not fill the card: the D 512 serve's decode (8 lanes, 8
    query heads over one: 8 blocks) splits 16 ways over 1024 positions,
    its verify (9 rows a lane: 2 tiles) 9 ways, DeepSeek-V4-Flash's
    decode (64 heads: one tile) 16; a 256-row chunk fills the card and
    runs whole.  Never past one split a 64-key stage or MAX_SPLITS, and B
    x splits stays within the grid's 65,535."""
    n_sm = 132
    assert ragged_splits(8, 1, 8, 1, 64, 16, n_sm, "wgmma-wide", 512) == 16
    assert ragged_splits(8, 9, 8, 1, 64, 16, n_sm, "wgmma-wide", 512) == 9
    assert ragged_splits(8, 1, 64, 1, 128, 16, n_sm, "wgmma-wide", 512) == 16
    assert ragged_splits(8, 1, 8, 1, 2, 16, n_sm, "wgmma-wide", 512) == 1
    assert ragged_splits(8, 256, 8, 1, 64, 16, n_sm, "wgmma-wide", 512) == 1
    # D 1024 has two column blocks a tile: half the splits
    assert ragged_splits(8, 1, 8, 1, 64, 16, n_sm, "wgmma-wide", 1024) == 9
    for b in (1, 2, 3, 8, 33, 131, 132, 1000, 65535):
        for m in (1, 9, 256):
            for d in (272, 512, 576, 2048):
                args = (b, m, 8, 1, 128, 16, n_sm, "wgmma-wide", d)
                n = ragged_splits(*args)
                assert n == ragged_splits(*args)
                assert 1 <= n <= MAX_SPLITS and b * n <= 65535


@pytest.mark.parametrize("lo,hi", [(272, 1024), (1040, 4096)])
def test_wgmma_wide_smem_fits_every_head_dim(lo, hi):
    """The shared-memory plan stays within a block's 232,448 bytes at every
    D from 272 to 4096 in steps of 16, with Q resident through D 640 and
    streamed past it, and at most 512 output columns a block."""
    for d in range(lo, hi + 1, 16):
        p = wgmma_wide_plan(d)
        assert p["bytes"] <= WGMMA_WIDE_SMEM_LIMIT, (d, p)
        assert p["resident"] == (d <= 640), (d, p)
        assert p["n_cb"] == -(-d // 512)


def test_wgmma_wide_plan_mirrors_the_source():
    """The Python mirror reads the CUDA plan's constants as written in
    ``csrc/wide_wgmma.cuh``."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["LAG"]) == ra._WW_LAG
    assert int(consts["BQ"]) == ra.WGMMA_WIDE_ROWS
    assert int(consts["BLOCK_VUNITS"]) * 128 == ra.WGMMA_WIDE_BLOCK_COLS
    assert "constexpr int RING = LAG + 2;" in src
    assert "constexpr int XBUF = 32 * 128 * 4;" in src
    assert "constexpr int HALF = 64 * 128;" in src
    assert int(consts["BAR_BYTES"]) == ra._WW_BARS
    assert "constexpr size_t SMEM_LIMIT = 232448;" in src
    assert ra._WW_RING == ra._WW_LAG + 2 and ra._WW_XBUF == 32 * 128 * 4
    assert ra._WW_UNIT == 2 * ra._WW_HALF == 2 * 64 * 128


# ------------------------------------------------ the plain versions on CPU
@pytest.mark.parametrize("q_dt,kv_dt", [("float16", "float16"),
                                        ("float16", "float8_e5m2"),
                                        ("bfloat16", "float8_e5m2")])
@pytest.mark.parametrize("d", (320, 576))
def test_ragged_new_pairs_match_tpulab(d, q_dt, kv_dt):
    """The pairs the tensor-core wide form takes that
    ``tests/test_torch_head_dims_past_256.py`` does not hold: decode, a chunk over context, verify rows
    and an idle lane, 8 query heads over one."""
    q, pool, tables = _inputs(d + 3, 4, 8, 8, 1, d, 8, 4)
    q_lens, kv_lens = RA_LENS
    jq, tq = _q(q, q_dt)
    jpool, tpool = _pool(pool, kv_dt)
    want = np.asarray(tpu_rpa(jq, jpool, jnp.asarray(tables),
                              jnp.asarray(q_lens, jnp.int32),
                              jnp.asarray(kv_lens, jnp.int32)), np.float32)
    got = ragged_paged_attention(tq, tpool, torch.from_numpy(tables),
                                 torch.tensor(q_lens, dtype=torch.int32),
                                 torch.tensor(kv_lens, dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == q.shape
    for lane, n in enumerate(q_lens):
        np.testing.assert_allclose(got[lane, :n].float().numpy(),
                                   want[lane, :n], rtol=TOL[q_dt],
                                   atol=TOL[q_dt])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", (320, 576))
def test_flash_f16_past_256_matches_tpulab(d, causal):
    rng = np.random.default_rng(d + 7 * causal)
    arrs = [rng.standard_normal((1, 64, 2, d)).astype(np.float32)
            for _ in range(3)]
    want = np.asarray(tpu_flash(*(_q(a, "float16")[0] for a in arrs),
                                causal=causal, block_q=32, block_k=32),
                      np.float32)
    got = flash_attention(*(_q(a, "float16")[1] for a in arrs),
                          causal=causal, block_q=32, block_k=32)
    assert got.dtype == torch.float16 and got.shape == (1, 64, 2, d)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=TOL["float16"], atol=TOL["float16"])


# ------------------------------------------------------------ on the card
def _ragged_args(dev, d, q_dt, kv_dt, hq, hkv, seed):
    q, pool, tables = _inputs(seed, 8, 64, hq, hkv, d, 16, 72)
    return (torch.from_numpy(q).to(dev, getattr(torch, q_dt)),
            torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
            torch.from_numpy(tables).to(dev),
            torch.tensor(CARD_LENS[0], dtype=torch.int32, device=dev),
            torch.tensor(CARD_LENS[1], dtype=torch.int32, device=dev))


def _ran(counts, before):
    return {k: n - before.get(k, 0) for k, n in counts.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512, 576, 1024])
@pytest.mark.parametrize("q_dt,kv_dt", TC_PAIRS)
def test_cuda_ragged_wgmma_wide(d, q_dt, kv_dt):
    """Kernel 1 on ``"wgmma-wide"`` against its plain version: decode at
    a page boundary and mid-page, verify rows, a 64-row chunk, an idle
    lane and 1033 positions; 8 query heads over one (one tile) and 16
    over 2; rows past q_lens zeros, a second launch bit-identical."""
    dev = _card()
    form = body_form("wgmma-wide", getattr(torch, q_dt))
    for hq, hkv in ((8, 1), (16, 2)):
        args = _ragged_args(dev, d, q_dt, kv_dt, hq, hkv, d + hq)
        n0 = dict(ra.ragged_paged_attention.launches_by_form)
        got = ragged_paged_attention(*args)
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        ran = _ran(ra.ragged_paged_attention.launches_by_form, n0)
        assert ran == {f: 2 if f == form else 0 for f in ran}
        assert torch.equal(got, again)
        _card_close(got, ragged_paged_attention_reference(*args))
        for lane, n in enumerate(CARD_LENS[0]):
            assert not got[lane, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 576])
@pytest.mark.parametrize("n_split", [1, 3, 5, MAX_SPLITS])
def test_cuda_ragged_wgmma_wide_split_counts(d, n_split, monkeypatch):
    """Split counts forced, odd ones included, bf16 over bf16 and f16
    over e4m3 pages: the merge in log2 units, (m, l) at an even offset,
    the same output as one split within the tolerance and bit for bit
    on relaunch."""
    dev = _card()
    monkeypatch.setattr(ra, "ragged_splits", lambda *a: n_split)
    for q_dt, kv_dt in (("bfloat16", "bfloat16"),
                        ("float16", "float8_e4m3fn")):
        args = _ragged_args(dev, d, q_dt, kv_dt, 3, 1, d + n_split)
        got = ragged_paged_attention(*args)
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _card_close(got, ragged_paged_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512, 576, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("t", [1, 63, 200, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_wgmma_wide(d, dtype, t, causal):
    """Kernel 2 on ``"wgmma-wide"`` against its plain version, on strided
    views (q, k, v slices of one fused tensor), a second launch
    bit-identical."""
    dev = _card()
    rng = np.random.default_rng(d + t)
    dt = getattr(torch, dtype)
    b, h = (1, 1) if t == 2048 else (2, 2)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d)).astype(
        np.float32)).to(dev, dt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    form = body_form("wgmma-wide", dt)
    n0 = dict(flash_attention.launches_by_form)
    got = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
    again = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
    torch.cuda.synchronize()
    ran = _ran(flash_attention.launches_by_form, n0)
    assert ran == {f: 2 if f == form else 0 for f in ran}
    assert torch.equal(got, again)
    _card_close(got, flash_attention_reference(q, k, v, causal))


@pytest.mark.cuda
def test_cuda_wgmma_wide_attributes():
    """Each new instantiation's shared memory at every D from 272 to 4096
    in steps of 16 within a block's 232,448 bytes (and equal to the
    Python mirror), and no local memory."""
    import ctypes

    from tpulab_torch.ops.flash_attention import _lib as flash_lib

    _card()
    rag = ra._lib().tpulab_ragged_wgmma_wide_attributes
    rag.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fla = flash_lib().tpulab_flash_wgmma_wide_attributes
    fla.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    for d in range(272, 4097, 16):
        for q_dt, kv_dt in TC_PAIRS:
            out = (ctypes.c_int * 3)()
            q, kv = getattr(torch, q_dt), getattr(torch, kv_dt)
            assert rag(Q_CODE[q], KV_CODE[kv], d, out) == 0
            assert out[1] == wgmma_wide_plan(d)["bytes"]
            assert out[1] <= WGMMA_WIDE_SMEM_LIMIT and out[2] == 0
        for q in (torch.bfloat16, torch.float16):
            out = (ctypes.c_int * 3)()
            assert fla(Q_CODE[q], d, out) == 0
            assert out[1] <= WGMMA_WIDE_SMEM_LIMIT and out[2] == 0
    assert FMA_WIDTH == 256 and CARD_TOL["bfloat16"] == (8e-3, 4e-3)
