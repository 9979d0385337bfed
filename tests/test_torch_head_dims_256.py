"""Kernels 1 and 2 at head dims 144-256 on the tensor cores.

Gemma-2-9B and Gemma-3-12B (16 query heads of D 256 over 8), Gemma-7B
(16 of D 256, MHA) and GPT-J-6B (16 of D 256) serve in bf16 or f16 at a
head dim past 128.  tpulab's ragged and flash kernels take any head dim
(``tpulab/ops/ragged_attention.py``, ``flash_attention.py``).  The port
runs the 16-bit pairs whose upcast to q's type is exact (bf16 q over
bf16, e4m3 or e5m2 pages; f16 q over f16, e4m3 or e5m2; kernel 2 in bf16
or f16) on the tensor cores at every multiple of 16 from 64 to 256
(``"wgmma"``: D 144-192 on the 192-wide tile, 208-256 on the 256-wide,
the columns past D zero); f32, the mixed pairs and the other head dims
stay on the ``"fma"`` bodies.  Here on the CPU: which body each call
takes, the split rule past width 128, and the plain versions against
tpulab's Pallas kernels in interpret mode on the same numpy inputs
(pages cast by tpulab and carried over as bytes) at D 144, 192 and 256;
tolerances by the output dtype, as ``tests/test_torch_head_dims.py``
holds them (f32 2e-5, bf16 2e-2, f16 2e-3).  A 2-layer batcher at D 256
(d_model 512, 2 heads over 1) gives tpulab's greedy tokens under both
plans.

The card's cases are marked ``cuda`` and skip without a card (``python
-m pytest --noconftest -m cuda tests/test_torch_head_dims_256.py``; the
card's machine has no JAX, so the reference imports are optional).  There
each new width is held against its plain version at the card's tolerance
(``CARD_TOL``: the kernel rounds P to q's type before P V, which the
plain version does not), relaunched bit for bit, its launches counted by
form and head dim, and each instantiation's registers, shared and local
memory read.
"""

import ctypes

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
    from tpulab.ops.ragged_attention import \
        ragged_paged_attention as tpu_rpa
except ImportError:
    jax = jnp = None
from test_torch_head_dims import CARD_TOL, PAIRS, TOL, _inputs, _pool, _q
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.ops import _build
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_body)
from tpulab_torch.ops.ragged_attention import (
    FMA_WIDTH, KV_CODE, MAX_SPLITS, Q_CODE, WGMMA_HEAD_DIMS, WGMMA_PAGES,
    ragged_body, ragged_paged_attention, ragged_paged_attention_reference,
    ragged_splits)

torch.set_num_threads(2)

#: the head dims held against tpulab: the narrowest of the 192-wide tile
#: (its columns past D zero), the tile's own width, Gemma's 256
DIMS_256 = (144, 192, 256)
#: every head dim the new tiles take
NEW_DIMS = tuple(d for d in WGMMA_HEAD_DIMS if d > 128)
#: the (q, page) pairs held against tpulab: the tensor-core pairs of both
#: q types (one fp8) and f32, which stays on the fma body
REF_PAIRS = (("bfloat16", "bfloat16"), ("float16", "float16"),
             ("bfloat16", "float8_e4m3fn"), ("float32", "float32"))
#: (q_lens, kv_lens) over 4 lanes of 4 pages of 8: decode, a chunk over
#: context, verify rows, an idle lane
RA_LENS = ([1, 8, 5, 0], [17, 16, 21, 0])
TC_PAIRS = [(q, kv) for q, kv in PAIRS
            if getattr(torch, kv) in WGMMA_PAGES.get(getattr(torch, q), ())]


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_body_rule_from_129_to_256(q_dt, kv_dt):
    """Every D from 129 to 256: ``"wgmma"`` exactly at the multiples of
    16 for the pairs of ``WGMMA_PAGES``, ``"fma"`` for every other D and
    pair (f32 and the mixed 16-bit pairs); kernel 2 (one dtype) alike."""
    q, kv = getattr(torch, q_dt), getattr(torch, kv_dt)
    tc = kv in WGMMA_PAGES.get(q, ())
    assert NEW_DIMS == (144, 160, 176, 192, 208, 224, 240, 256)
    for d in range(129, FMA_WIDTH + 1):
        want = "wgmma" if tc and d % 16 == 0 else "fma"
        assert ragged_body(q, kv, d) == want
        if q == kv:
            assert flash_body(q, d) == ("fma" if q == torch.float32
                                        else want)


def test_split_rule_past_width_128():
    """Past the 128-wide tile one ``"wgmma"`` block fits an SM (120 or
    160 KB of shared memory), so decode aims at one block per SM: at
    Gemma-2-9B's decode (8 lanes, 16 heads over 8, 128 pages of 16) 2
    splits (128 blocks) where D 128 takes 4 (256 blocks, two an SM); a
    function of shapes, the SM count and the head dim only."""
    n_sm = 132
    args = (8, 1, 16, 8, 128, 16, n_sm, "wgmma")
    assert ragged_splits(*args, 128) == 4
    for d in NEW_DIMS:
        assert ragged_splits(*args, d) == 2
        assert ragged_splits(*args, d) == ragged_splits(*args, d)
    # one lane: 8 blocks, 16 splits (MAX_SPLITS) at every width
    assert ragged_splits(1, 1, 16, 8, 128, 16, n_sm, "wgmma", 256) == \
        MAX_SPLITS
    # a 256-row chunk over 8 lanes fills the card: one split
    assert ragged_splits(8, 256, 16, 8, 128, 16, n_sm, "wgmma", 256) == 1
    # at most one split a 64-key stage of the table
    assert ragged_splits(1, 1, 16, 8, 2, 16, n_sm, "wgmma", 256) == 1


def test_the_new_unit_is_built():
    """The tensor-core body at D 144-256 of kernel 1 is a unit of its own
    of the ragged library, listed in ``_build.UNITS`` (nothing is
    globbed), and kernel 2's in the flash library's first unit."""
    unit = "ragged_attention_wgmma_256.cu"
    assert unit in _build.UNITS["ragged_attention"]
    assert (_build.CSRC / unit).exists()
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for w in (192, 256):
        assert f"tc::launch<{w}, T16, false>" in src
        assert f"tc::launch<{w}, T16, true>" in src


# ------------------------------------------------------ kernel 1 vs tpulab
@pytest.mark.parametrize("d", DIMS_256)
@pytest.mark.parametrize("q_dt,kv_dt", REF_PAIRS)
@pytest.mark.parametrize("g", [1, 2])
def test_ragged_256_matches_tpulab(q_dt, kv_dt, d, g):
    """Decode, a chunk over context, verify rows and an idle lane, GQA
    group 1 (2 heads over 2) and 2 (4 over 2)."""
    q, pool, tables = _inputs(d + g, 4, 8, 2 * g, 2, d, 8, 4)
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
        assert not got[lane, n:].any()


# ------------------------------------------------------ kernel 2 vs tpulab
@pytest.mark.parametrize("d", DIMS_256)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_256_matches_tpulab(dtype, causal, d):
    rng = np.random.default_rng(d + causal)
    arrs = [rng.standard_normal((2, 64, 2, d)).astype(np.float32)
            for _ in range(3)]
    want = np.asarray(tpu_flash(*(_q(a, dtype)[0] for a in arrs),
                                causal=causal, block_q=32, block_k=32),
                      np.float32)
    got = flash_attention(*(_q(a, dtype)[1] for a in arrs), causal=causal,
                          block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 64, 2, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


# --------------------------------------------------------- the batcher
#: a 2-layer model at head dim 256, 2 query heads over 1 (a Gemma-2-9B
#: head geometry at a CPU test's width)
LM_256 = dict(vocab=64, d_model=512, n_heads=2, n_layers=2, d_ff=256,
              n_kv_heads=1)


@pytest.mark.parametrize("plan", ["ragged", "split"])
def test_batcher_d256_matches_tpulab(plan):
    """Greedy tokens of three requests (lanes 2: one queues) through the
    port's batcher, its weights carried over from tpulab's by
    ``models/convert.py``, equal tpulab's under the ragged and the split
    plan."""
    from tpulab_torch.models.convert import params_from_numpy

    cfg = LM_256
    geo = dict(n_heads=cfg["n_heads"], n_layers=cfg["n_layers"], lanes=2,
               max_len=64, page_size=8, n_kv_heads=cfg["n_kv_heads"])
    jparams = jax_init(**cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu", n_heads=cfg["n_heads"])
    prompts = [np.random.default_rng(s).integers(0, 64, (5 + 3 * s,),
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
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_close(got, want):
    rtol, atol = CARD_TOL[str(got.dtype).split(".")[-1]]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _form(dtype):
    return "wgmma f16" if dtype == torch.float16 else "wgmma bf16"


#: (q_lens, kv_lens) at 8 lanes over 72 pages of 16: decode at a page
#: boundary and mid-page, verify rows, a chunk, an idle lane, long context
CARD_LENS = ([1, 1, 9, 64, 0, 1, 3, 17], [16, 17, 1033, 200, 0, 1024, 40,
                                           17])


@pytest.mark.cuda
@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("q_dt,kv_dt", TC_PAIRS)
def test_cuda_ragged_256(q_dt, kv_dt, d):
    """Each tensor-core pair at each new head dim, GQA 2 over 1 and 4
    over 2, against its plain version; rows past q_lens zeros; a second
    launch bit-identical; both launches counted under the form and the
    head dim."""
    dev = _card()
    q_dtype, kv_dtype = getattr(torch, q_dt), getattr(torch, kv_dt)
    assert ragged_body(q_dtype, kv_dtype, d) == "wgmma"
    for hq, hkv in ((2, 1), (4, 2)):
        q, pool, tables = _inputs(d + hq, 8, 64, hq, hkv, d, 16, 72)
        args = (torch.from_numpy(q).to(dev, q_dtype),
                torch.from_numpy(pool).to(dev).to(kv_dtype),
                torch.from_numpy(tables).to(dev),
                torch.tensor(CARD_LENS[0], dtype=torch.int32, device=dev),
                torch.tensor(CARD_LENS[1], dtype=torch.int32, device=dev))
        form = dict(ragged_paged_attention.launches_by_form)
        dims = dict(ragged_paged_attention.launches_by_head_dim)
        got = ragged_paged_attention(*args)
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        ran = {k: n - form[k]
               for k, n in ragged_paged_attention.launches_by_form.items()}
        assert ran == {k: 2 if k == _form(q_dtype) else 0 for k in ran}
        assert ragged_paged_attention.launches_by_head_dim[d] == \
            dims.get(d, 0) + 2
        assert torch.equal(got, again)
        _card_close(got, ragged_paged_attention_reference(*args))
        for lane, n in enumerate(CARD_LENS[0]):
            assert not got[lane, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [160, 192, 240, 256])
@pytest.mark.parametrize("n_split", [1, 3, MAX_SPLITS])
def test_cuda_ragged_256_split_counts(d, n_split, monkeypatch):
    """The new tiles with split counts forced (the merge kernel at widths
    192 and 256, a head dim under each), bf16 over bf16 and f16 over
    e5m2 pages."""
    dev = _card()
    from tpulab_torch.ops import ragged_attention as ra

    monkeypatch.setattr(ra, "ragged_splits", lambda *a: n_split)
    for q_dt, kv_dt in (("bfloat16", "bfloat16"), ("float16", "float8_e5m2")):
        q, pool, tables = _inputs(d + n_split, 8, 64, 4, 2, d, 16, 72)
        args = (torch.from_numpy(q).to(dev, getattr(torch, q_dt)),
                torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
                torch.from_numpy(tables).to(dev),
                torch.tensor(CARD_LENS[0], dtype=torch.int32, device=dev),
                torch.tensor(CARD_LENS[1], dtype=torch.int32, device=dev))
        got = ragged_paged_attention(*args)
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _card_close(got, ragged_paged_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("t", [1, 63, 200, 2048])
def test_cuda_flash_256(dtype, t, d):
    """Contiguous and strided (a fused projection's views) q / k / v,
    causal and full, against the plain version: the ``"wgmma"`` body,
    bit-identical twice, counted under the form and the head dim."""
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(t * d)
    h = 2 if t == 2048 else 3
    contiguous = [torch.from_numpy(rng.standard_normal(
        (2, t, h, d)).astype(np.float32)).to(dev, dt) for _ in range(3)]
    fused = torch.from_numpy(rng.standard_normal(
        (1, t, 3 * h, d)).astype(np.float32)).to(dev, dt)
    strided = [fused[:, :, :h], fused[:, :, h:2 * h], fused[:, :, 2 * h:]]
    assert flash_body(dt, d) == "wgmma"
    for q, k, v in (contiguous, strided):
        for causal in (True, False):
            form = dict(flash_attention.launches_by_form)
            dims = dict(flash_attention.launches_by_head_dim)
            got = flash_attention(q, k, v, causal=causal, block_q=t,
                                  block_k=t)
            again = flash_attention(q, k, v, causal=causal, block_q=t,
                                    block_k=t)
            torch.cuda.synchronize()
            ran = {key: n - form[key]
                   for key, n in flash_attention.launches_by_form.items()}
            assert ran == {key: 2 if key == _form(dt) else 0 for key in ran}
            assert flash_attention.launches_by_head_dim[d] == \
                dims.get(d, 0) + 2
            assert torch.equal(got, again)
            _card_close(got, flash_attention_reference(q, k, v, causal))


#: bytes of shared memory a block can use (227 KB)
SMEM_LIMIT = 232448


@pytest.mark.cuda
@pytest.mark.parametrize("d", NEW_DIMS)
def test_cuda_new_tiles_fit(d):
    """Every instantiation of the new tiles (kernel 1: each tensor-core
    pair; kernel 2: bf16 and f16) within a block's shared memory, with no
    local memory (no spills); kernel 1's five tiles leave one block an
    SM, which ``ragged_splits`` assumes."""
    _card()
    from tpulab_torch.ops.flash_attention import _lib as fa_lib
    from tpulab_torch.ops.ragged_attention import _lib as ra_lib

    rag = ra_lib().tpulab_ragged_wgmma_attributes
    rag.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fla = fa_lib().tpulab_flash_wgmma_attributes
    fla.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    width = 192 if d <= 192 else 256
    for q_dt, kv_dt in TC_PAIRS:
        out = (ctypes.c_int * 3)()
        assert rag(Q_CODE[getattr(torch, q_dt)],
                   KV_CODE[getattr(torch, kv_dt)], d, out) == 0
        regs, smem, local = out
        assert smem == 5 * 64 * width * 2 + 1024
        assert 2 * smem > SMEM_LIMIT and local == 0 and regs <= 255
    for dt in (torch.bfloat16, torch.float16):
        out = (ctypes.c_int * 3)()
        assert fla(Q_CODE[dt], d, out) == 0
        regs, smem, local = out
        assert smem <= SMEM_LIMIT and local == 0 and regs <= 255
    # the C entries refuse what the new tiles do not take
    out = (ctypes.c_int * 3)()
    assert rag(Q_CODE[torch.float32], KV_CODE[torch.float32], d, out) == -1
    assert rag(Q_CODE[torch.bfloat16], KV_CODE[torch.bfloat16], 128,
               out) == -1
    assert fla(Q_CODE[torch.float32], d, out) == -1

