"""Head dims past 256 on the port's three kernels.

tpulab's kernels take the head dim as a parameter with no upper limit
(``tpulab/ops/ragged_attention.py``, ``flash_attention.py``,
``paged_attention.py``); DeepSeek-V4-Flash's attention has 64 query heads
of D 512 over one KV head, sarvam-105b's latent heads are 576 wide.  The
port runs every D past 256 on a wide form: the 16-bit pairs whose upcast
is exact at a D that is a multiple of 16 on the tensor cores
(``"wgmma-wide"``, ``csrc/wide_wgmma.cuh``; kernels 1 and 2), every other
pair and D, and kernel 3, on the wide fma form (``"fma-wide"``,
``tpulab_torch/ops/csrc/wide_attention.cuh``: the output's columns in
slabs of 256, each block recomputing its rows' scores over the whole
head dim).  Here on the CPU each wrapper takes its plain version, held
against tpulab's Pallas kernel in interpret mode on the same numpy
inputs (pages cast by tpulab and carried over as bytes) at D 257, 320,
512 and 576: kernel 1's decode, chunk-over-context and verify rows with
an idle lane, kernel 2 causal and full, kernel 3's decode; f32, bf16 and
an e4m3 pool; GQA groups 1 and 8.  Tolerances by the output dtype, as
``tests/test_torch_head_dims.py`` holds them: f32 2e-5, bf16 2e-2.  A
2-layer ``ContinuousBatcher`` at D 512 (two query heads over one KV
head), its weights carried from tpulab's by ``convert.py``, gives
tpulab's greedy tokens under both plans.

The card's cases are marked ``cuda`` and skip without a card; there each
wide form is held against its plain version (the card's tolerances,
``CARD_TOL``) and relaunched bit for bit (``python -m pytest
--noconftest -m cuda tests/test_torch_head_dims_past_256.py``; the
card's machine has no JAX, so the reference imports are optional).
"""

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax
    import jax.numpy as jnp

    from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
    from tpulab.models.transformer import \
        init_transformer_params as jax_init
    from tpulab.ops.flash_attention import flash_attention as tpu_flash
    from tpulab.ops.paged_attention import \
        paged_decode_attention as tpu_pda
    from tpulab.ops.ragged_attention import \
        ragged_paged_attention as tpu_rpa
except ImportError:
    jax = jnp = None
from test_torch_head_dims import RA_LENS, TOL, _inputs, _pool, _q
from test_torch_head_dims_wide import CARD_LENS, _card, _card_close
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.ops import paged_attention as pa
from tpulab_torch.ops import ragged_attention as ra
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_body)
from tpulab_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference, paged_form,
    paged_n_split)
from tpulab_torch.ops.ragged_attention import (
    FMA_WIDTH, MAX_SPLITS, WIDE_COLS, check_built, head_dim_built,
    ragged_body, ragged_paged_attention, ragged_paged_attention_reference,
    ragged_splits, wide_slabs, wide_splits)

torch.set_num_threads(2)

#: past 256 by one (an odd D: odd rows, a last chunk of one column), a
#: last chunk of 64, DeepSeek-V4-Flash's 512, sarvam-105b's 576
PAST_DIMS = (257, 320, 512, 576)
#: (q, page) dtypes: f32 over f32, bf16 over bf16, bf16 over e4m3
MIXES = (("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float8_e4m3fn"))
#: (Hq, Hkv): GQA groups 1 and 8
GROUPS = ((2, 2), (8, 1))


# ------------------------------------------------------------- kernel 1
@pytest.mark.parametrize("hq,hkv", GROUPS)
@pytest.mark.parametrize("q_dt,kv_dt", MIXES)
@pytest.mark.parametrize("d", PAST_DIMS)
def test_ragged_past_256_matches_tpulab(d, q_dt, kv_dt, hq, hkv):
    """Decode, a chunk over context, verify rows and an idle lane."""
    q, pool, tables = _inputs(d + hq, 4, 8, hq, hkv, d, 8, 4)
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
    tol = TOL[q_dt]
    for lane, n in enumerate(q_lens):
        np.testing.assert_allclose(got[lane, :n].float().numpy(),
                                   want[lane, :n], rtol=tol, atol=tol)


# ------------------------------------------------------------- kernel 2
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", PAST_DIMS)
def test_flash_past_256_matches_tpulab(d, dtype, causal):
    rng = np.random.default_rng(d + causal)
    arrs = [rng.standard_normal((1, 64, 2, d)).astype(np.float32)
            for _ in range(3)]
    want = np.asarray(tpu_flash(*(_q(a, dtype)[0] for a in arrs),
                                causal=causal, block_q=32, block_k=32),
                      np.float32)
    got = flash_attention(*(_q(a, dtype)[1] for a in arrs), causal=causal,
                          block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, 64, 2, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


# ------------------------------------------------------------- kernel 3
#: inclusive positions: on a page boundary (7, 8), past the first page,
#: position 0
PD_LENGTHS = [7, 8, 20, 0]


@pytest.mark.parametrize("hq,hkv", GROUPS)
@pytest.mark.parametrize("q_dt,kv_dt", MIXES)
@pytest.mark.parametrize("d", PAST_DIMS)
def test_paged_past_256_matches_tpulab(d, q_dt, kv_dt, hq, hkv):
    q, pool, tables = _inputs(d + 2 * hq, 4, 1, hq, hkv, d, 8, 4)
    jq, tq = _q(q[:, 0], q_dt)
    jpool, tpool = _pool(pool, kv_dt)
    want = np.asarray(tpu_pda(jq, jpool, jnp.asarray(tables),
                              jnp.asarray(PD_LENGTHS, jnp.int32)),
                      np.float32)
    got = paged_decode_attention(tq, tpool, torch.from_numpy(tables),
                                 torch.tensor(PD_LENGTHS, dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == q[:, 0].shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[q_dt],
                               atol=TOL[q_dt])


# ---------------------------------------------------------- the host rules
@pytest.mark.parametrize("d", (257, 512, 576, 1024, 2048))
def test_wide_form_is_built_past_256(d):
    """Every D past 256 is built, for every (q, page) pair, on a wide form
    of all three kernels: the tensor-core one for the 16-bit pairs whose
    upcast is exact at a D that is a multiple of 16 (kernels 1 and 2),
    the fma one for every other pair and D, and for kernel 3."""
    for q in ra.Q_CODE:
        tc = q != torch.float32 and d % 16 == 0
        for kv in ra.KV_CODE:
            check_built(q, kv, d)
            assert ragged_body(q, kv, d) == (
                "wgmma-wide" if tc and kv in ra.WGMMA_PAGES[q]
                else "fma-wide")
        assert flash_body(q, d) == ("wgmma-wide" if tc else "fma-wide")
    assert head_dim_built(d) and paged_form(d) == "fma-wide"
    assert paged_form(FMA_WIDTH) == "ring"
    assert wide_slabs(d) == -(-d // WIDE_COLS) >= 2


def test_wide_splits_are_a_function_of_shapes():
    """Split-KV where the wide form's blocks do not fill the card: the
    D 512 serve's decode (8 lanes, one KV head, G 8: one tile, two slabs,
    16 blocks) splits into 8 over 1024 positions, never past MAX_SPLITS
    or one split a 128 positions; a 256-row chunk fills the card alone."""
    assert ragged_splits(8, 1, 8, 1, 64, 16, 132, "fma-wide", 512) == 8
    assert ragged_splits(8, 1, 8, 1, 128, 16, 132, "fma-wide", 512) == 16
    assert ragged_splits(1, 1, 64, 1, 128, 16, 132, "fma-wide", 576) == 16
    assert ragged_splits(1, 1, 8, 1, 1, 16, 132, "fma-wide", 512) == 1
    assert ragged_splits(8, 256, 8, 1, 64, 16, 132, "fma-wide", 512) == 1
    assert ragged_splits(8, 1, 8, 1, 64, 16, 132, "fma", 256) == 1
    assert paged_n_split(8, 64, 1, 512, 64, 16, 132) == wide_splits(
        2 * 2 * 8, 1024, 132) == 8
    for blocks in range(1, 300):
        n = wide_splits(blocks, 4096, 132)
        assert 1 <= n <= MAX_SPLITS and (blocks < 132 or n == 1)


def test_the_batcher_takes_d512_where_the_card_would():
    """The CUDA batcher's construction check passes at the D 512 serve's
    geometry (Llama-3-8B's d_model 4096 over 8 heads) and at sarvam's
    576; a head dim below 1 is refused."""
    for q, kv in ((torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float8_e4m3fn),
                  (torch.float32, torch.float32)):
        check_built(q, kv, 4096 // 8)
        check_built(q, kv, 576)
        with pytest.raises(ValueError, match="not built"):
            check_built(q, kv, 0)


# --------------------------------------------------------- the batcher
#: D 512: two query heads of 512 over one KV head, Llama-3's SwiGLU and
#: untied head at a width the CPU runs
LM = dict(vocab=64, d_model=1024, n_heads=2, n_layers=2, d_ff=256,
          n_kv_heads=1)


@pytest.mark.parametrize("plan", ["ragged", "split"])
def test_batcher_d512_matches_tpulab(plan):
    """Greedy tokens of three requests (lanes 2: one queues) through the
    port's batcher at D 512 equal tpulab's, under both plans."""
    from tpulab_torch.models.convert import params_from_numpy

    cfg = LM
    geo = dict(n_heads=cfg["n_heads"], n_layers=cfg["n_layers"], lanes=2,
               max_len=64, page_size=8, n_kv_heads=cfg["n_kv_heads"])
    jparams = jax_init(**cfg, ffn="swiglu", tie_embeddings=False)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu", n_heads=cfg["n_heads"],
                               n_kv_heads=cfg["n_kv_heads"])
    prompts = [np.random.default_rng(s).integers(0, 64, (5 + 4 * s,),
                                                 np.int32)
               for s in range(3)]
    jkw = (dict(ragged=True, use_kernel=False) if plan == "ragged"
           else dict(use_kernel=False))
    ref = JaxBatcher(jparams, compute_dtype=jnp.float32, **geo, **jkw)
    try:
        want = [list(map(int, f.result(timeout=300)))
                for f in [ref.submit(p, 7) for p in prompts]]
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(params, compute_dtype=torch.float32,
                           ragged=plan == "ragged", device="cpu", **geo)
    try:
        got = [list(map(int, f.result(timeout=300)))
               for f in [cb.submit(p, 7) for p in prompts]]
    finally:
        cb.shutdown()
    assert got == want


# ------------------------------------------------------------ on the card
CARD_PAIRS = [(q, kv) for q in ("float32", "bfloat16", "float16")
              for kv in ("float32", "bfloat16", "float16", "float8_e4m3fn",
                         "float8_e5m2")]


def _ragged_args(dev, d, q_dt, kv_dt, hq, hkv, seed):
    q, pool, tables = _inputs(seed, 8, 64, hq, hkv, d, 16, 72)
    return (torch.from_numpy(q).to(dev, getattr(torch, q_dt)),
            torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
            torch.from_numpy(tables).to(dev),
            torch.tensor(CARD_LENS[0], dtype=torch.int32, device=dev),
            torch.tensor(CARD_LENS[1], dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 320, 384, 512, 576, 1024])
@pytest.mark.parametrize("q_dt,kv_dt", CARD_PAIRS)
def test_cuda_ragged_past_256(d, q_dt, kv_dt):
    """Kernel 1's wide forms against their plain version at every (q,
    page) pair (the tensor-core pairs at D % 16 == 0 on ``"wgmma-wide"``,
    the others on ``"fma-wide"``), rows past q_lens zeros, a second
    launch bit-identical."""
    dev = _card()
    args = _ragged_args(dev, d, q_dt, kv_dt, 8, 1, d)
    form = ra.body_form(ragged_body(args[0].dtype, args[1].dtype, d),
                        args[0].dtype)
    n0 = dict(ra.ragged_paged_attention.launches_by_form)
    got = ragged_paged_attention(*args)
    again = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ran = {f: n - n0[f]
           for f, n in ra.ragged_paged_attention.launches_by_form.items()}
    assert ran == {f: 2 if f == form else 0 for f in ran}
    assert torch.equal(got, again)
    _card_close(got, ragged_paged_attention_reference(*args))
    for lane, n in enumerate(CARD_LENS[0]):
        assert not got[lane, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,hkv", [(257, 1), (257, 3), (325, 3), (512, 1)])
@pytest.mark.parametrize("n_split", [1, 3, 5, MAX_SPLITS])
def test_cuda_ragged_past_256_split_counts(d, hkv, n_split, monkeypatch):
    """The wide form with split counts forced: odd D over odd split
    counts (the (m, l) pairs after an odd count of partials), one and
    three KV heads, f32 and bf16 over e5m2 pages."""
    dev = _card()
    monkeypatch.setattr(ra, "ragged_splits", lambda *a: n_split)
    for q_dt, kv_dt in (("float32", "float32"), ("bfloat16", "float8_e5m2")):
        args = _ragged_args(dev, d, q_dt, kv_dt, 3 * hkv, hkv, d + n_split)
        got = ragged_paged_attention(*args)
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _card_close(got, ragged_paged_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 320, 512, 576])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("t", [1, 63, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_past_256(d, dtype, t, causal):
    """Kernel 2's wide forms against their plain version (bf16 and f16
    at D % 16 == 0 on ``"wgmma-wide"``, the others on ``"fma-wide"``),
    and on a strided view (k, v slices of one fused tensor)."""
    dev = _card()
    rng = np.random.default_rng(d + t)
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(rng.standard_normal((2, t, 3, 2, d)).astype(
        np.float32)).to(dev, dt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    form = ra.body_form(flash_body(dt, d), dt)
    n0 = dict(flash_attention.launches_by_form)
    got = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
    again = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
    torch.cuda.synchronize()
    ran = {f: n - n0[f]
           for f, n in flash_attention.launches_by_form.items()}
    assert ran == {f: 2 if f == form else 0 for f in ran}
    assert torch.equal(got, again)
    _card_close(got, flash_attention_reference(q, k, v, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 512, 576, 1024])
@pytest.mark.parametrize("hq,hkv", [(1, 1), (3, 3), (8, 1), (64, 1)])
@pytest.mark.parametrize("q_dt,kv_dt", [("float32", "float32"),
                                        ("bfloat16", "bfloat16"),
                                        ("float16", "float8_e4m3fn")])
def test_cuda_paged_past_256(d, hq, hkv, q_dt, kv_dt):
    """Kernel 3's wide form against its plain version (MQA's 64 query
    heads over one: two tiles), a second launch bit-identical."""
    dev = _card()
    q, pool, tables = _inputs(d + hq, 8, 1, hq, hkv, d, 16, 72)
    lengths = [15, 16, 1032, 199, 0, 1023, 39, 16]
    args = (torch.from_numpy(q[:, 0]).to(dev, getattr(torch, q_dt)),
            torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))
    n0 = dict(pa.paged_decode_attention.launches_by_form)
    got = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches_by_form["fma-wide"] == (
        n0["fma-wide"] + 2)
    assert torch.equal(got, again)
    _card_close(got, paged_decode_attention_reference(*args))
