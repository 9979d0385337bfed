"""tpulab's own small-model geometry on the port's three kernels.

tpulab's tests and five of its bench rows run d_model 32 over 2 heads
(head dim 16; ``tests/test_paged.py``), and bench.py's rows d_model 64
over 4 heads (D 16 again); its kernels take any head dim and any GQA
group.  The port builds kernels 1-3 at D 16, kernel 3 also at D 32, and
kernel 3 for groups past 8 query heads a KV head (G 16, MQA's 32 over
1).  Here on the CPU each wrapper takes its plain version, held against
tpulab's Pallas kernel in interpret mode on the same numpy inputs (pages
cast by tpulab and carried over as bytes) for every (q, page) pair the
port builds.  Tolerances by the output dtype: f32 2e-5 (summation order
differs), bf16 2e-2 and f16 2e-3 (the output rounds to q's type at
different points), as the existing kernel tests hold them.

A paged ``ContinuousBatcher`` at ``tests/test_paged.py``'s widths (and
its MQA variant), and at head dims 96 and 80 (MQA), gives tpulab's
greedy tokens under both plans.

The CUDA forms have no CPU mode: their cases are marked ``cuda`` and
skip without a card; there they hold each form against its plain
version (``python -m pytest --noconftest -m cuda
tests/test_torch_head_dims.py``; the card's machine has no JAX, so the
reference imports are optional).
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
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.ops import paged_attention as pa
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_body)
from tpulab_torch.ops.paged_attention import (
    GROUP_BLOCK, group_blocks, paged_decode_attention,
    paged_decode_attention_reference, paged_splits)
from tpulab_torch.ops.ragged_attention import (
    FMA_WIDTH, KV_CODE, Q_CODE, WGMMA_HEAD_DIMS, WGMMA_PAGES, check_built,
    head_dim_built, ragged_body, ragged_paged_attention,
    ragged_paged_attention_reference)

torch.set_num_threads(2)

Q_DTYPES = ("float32", "bfloat16", "float16")
KV_DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn",
             "float8_e5m2")
PAIRS = [(q, kv) for q in Q_DTYPES for kv in KV_DTYPES]
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}
#: the card's tolerances (chip_smoke's TOL): (rtol, atol) by output dtype
CARD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 4e-3),
            "float16": (2e-3, 1e-3)}


def _inputs(seed, b, m, hq, hkv, d, s, mp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, m, hq, d)).astype(np.float32)
    pool = rng.standard_normal((b * mp + 1, 2, s, hkv, d)).astype(np.float32)
    tables = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    return q, pool, tables


def _pool(arr, name):
    """``arr`` cast by tpulab (jnp) to page dtype ``name``: the jax array
    and the port's tensor of the same bytes."""
    jpool = jnp.asarray(arr).astype(getattr(jnp, name))
    raw = np.asarray(jpool)
    if raw.itemsize == 1:
        t = torch.from_numpy(raw.view(np.uint8).copy()).view(
            getattr(torch, name))
    elif raw.itemsize == 2:
        t = torch.from_numpy(raw.view(np.int16).copy()).view(
            getattr(torch, name))
    else:
        t = torch.from_numpy(raw.copy())
    return jpool, t


def _q(arr, name):
    return (jnp.asarray(arr).astype(getattr(jnp, name)),
            torch.from_numpy(arr).to(getattr(torch, name)))


# ------------------------------------------------------------ kernel 1, D 16
#: (q_lens, kv_lens): decode, a chunk over context, verify rows, an idle lane
RA_LENS = ([1, 8, 5, 0], [17, 16, 21, 0])


@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_ragged_d16_matches_tpulab(q_dt, kv_dt):
    q, pool, tables = _inputs(16, 4, 8, 2, 2, 16, 8, 4)
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


@pytest.mark.parametrize("hq,hkv", [(4, 1), (16, 1)])
def test_ragged_d16_gqa_matches_tpulab(hq, hkv):
    """The MQA variant of tpulab's batcher test (4 heads over 1) and a
    group of 16, f32."""
    q, pool, tables = _inputs(17, 3, 5, hq, hkv, 16, 8, 3)
    q_lens, kv_lens = [1, 5, 3], [20, 9, 24]
    want = np.asarray(tpu_rpa(jnp.asarray(q), jnp.asarray(pool),
                              jnp.asarray(tables),
                              jnp.asarray(q_lens, jnp.int32),
                              jnp.asarray(kv_lens, jnp.int32)))
    got = ragged_paged_attention(torch.from_numpy(q),
                                 torch.from_numpy(pool),
                                 torch.from_numpy(tables),
                                 torch.tensor(q_lens, dtype=torch.int32),
                                 torch.tensor(kv_lens, dtype=torch.int32))
    for lane, n in enumerate(q_lens):
        np.testing.assert_allclose(got[lane, :n].numpy(), want[lane, :n],
                                   rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ kernel 2, D 16
@pytest.mark.parametrize("dtype", Q_DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_d16_matches_tpulab(dtype, causal):
    rng = np.random.default_rng(160)
    arrs = [rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
            for _ in range(3)]
    want = np.asarray(tpu_flash(*(_q(a, dtype)[0] for a in arrs),
                                causal=causal, block_q=32, block_k=32),
                      np.float32)
    got = flash_attention(*(_q(a, dtype)[1] for a in arrs), causal=causal,
                          block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 64, 2, 16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


# ------------------------------------------------- kernel 3, D 16 and 32
#: inclusive positions: on a page boundary (7, 8), past the first page,
#: position 0
PD_LENGTHS = [7, 8, 20, 0]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_paged_matches_tpulab(q_dt, kv_dt, d):
    q, pool, tables = _inputs(d, 4, 1, 2, 2, d, 8, 4)
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


#: groups past 8 query heads a KV head: G 16 and MQA's Hq 32 over Hkv 1
BIG_GROUPS = [(32, 2), (32, 1)]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("hq,hkv", BIG_GROUPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_big_groups_match_tpulab(hq, hkv, d, dtype):
    q, pool, tables = _inputs(hq + d, 3, 1, hq, hkv, d, 8, 3)
    jq, tq = _q(q[:, 0], dtype)
    jpool, tpool = _pool(pool, dtype)
    lengths = [23, 8, 0]
    want = np.asarray(tpu_pda(jq, jpool, jnp.asarray(tables),
                              jnp.asarray(lengths, jnp.int32)), np.float32)
    got = paged_decode_attention(tq, tpool, torch.from_numpy(tables),
                                 torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


# ---------------------------------------------------------- the host rules
@pytest.mark.parametrize("q_dt", Q_DTYPES)
@pytest.mark.parametrize("kv_dt", KV_DTYPES)
def test_d16_is_built_on_the_fma_body(q_dt, kv_dt):
    q, kv = getattr(torch, q_dt), getattr(torch, kv_dt)
    assert ragged_body(q, kv, 16) == "fma"
    for d in (16, 32):
        check_built(q, kv, d)
    if q == kv:
        assert flash_body(q, 16) == "fma"


def test_head_dims_of_the_three_kernels():
    """One rule for all three kernels: every head dim from 1 up, as
    tpulab's kernels take any (80, 96, 512, ...); D 0 refused, by the
    wrappers too.  The tensor-core bodies take the multiples of 16 from
    64 to 256 for the 16-bit pairs, the fma bodies everything else up to
    256, the wide form every D past it."""
    assert FMA_WIDTH == 256
    assert WGMMA_HEAD_DIMS == tuple(range(64, 257, 16))
    assert set(Q_CODE) == {getattr(torch, n) for n in Q_DTYPES}
    assert set(KV_CODE) == {getattr(torch, n) for n in KV_DTYPES}
    for q_dt, kv_dt in PAIRS:
        q, kv = getattr(torch, q_dt), getattr(torch, kv_dt)
        for d in range(1, FMA_WIDTH + 1):
            check_built(q, kv, d)
            assert head_dim_built(d)
            want = ("wgmma" if kv in WGMMA_PAGES.get(q, ())
                    and d in WGMMA_HEAD_DIMS else "fma")
            assert ragged_body(q, kv, d) == want
            if q == kv:
                assert flash_body(q, d) == (
                    "fma" if q == torch.float32 else want)
        for d in (264, 512):
            assert head_dim_built(d)
            check_built(q, kv, d)
            # past 256 the tensor-core pairs take the wide wgmma form at
            # a D that is a multiple of 16 (512, not 264)
            wide = ("wgmma-wide" if kv in WGMMA_PAGES.get(q, ())
                    and d % 16 == 0 else "fma-wide")
            assert ragged_body(q, kv, d) == wide
            if q == kv:
                assert flash_body(q, d) == (
                    "fma-wide" if q == torch.float32 else wide)
        assert not head_dim_built(0)
        with pytest.raises(ValueError, match="not built"):
            check_built(q, kv, 0)
    q, pool, tables = _inputs(0, 1, 1, 2, 2, 0, 8, 2)
    with pytest.raises(ValueError, match="not built"):
        pa._check(torch.from_numpy(q[:, 0]), torch.from_numpy(pool),
                  torch.from_numpy(tables), torch.tensor([3]))


def test_group_blocks_and_their_splits():
    """Blocks of 8 query heads a KV head; the split rule counts them as
    the grid does."""
    assert GROUP_BLOCK == 8
    assert [group_blocks(hq, hkv) for hq, hkv in (
        (2, 2), (4, 1), (32, 8), (16, 1), (32, 2), (32, 1), (12, 1))] == [
        1, 1, 1, 2, 2, 4, 2]
    # MQA (Hq 32 over 1) at 8 lanes x 2048 positions: 32 blocks, not 8,
    # to spread over the card
    assert paged_splits(8, 1, 128, 16, 132) == 16
    assert paged_splits(8, 1 * group_blocks(32, 1), 128, 16, 132) == 8


def test_the_batcher_takes_d16_where_the_card_would():
    """The CUDA batcher's construction check (``check_built`` over its
    compute dtype, page dtype and head dim) passes at tpulab's widths."""
    for d_model, n_heads in ((32, 2), (64, 4)):
        check_built(torch.float32, torch.float32, d_model // n_heads)


# --------------------------------------------------------- the batcher
#: tests/test_paged.py's model and its MQA variant; head dim 96
#: (Phi-3-mini's) and 80 (Phi-2's) under MQA
LMS = {"mha": dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64),
       "mqa": dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=64,
                   n_kv_heads=1),
       "d96": dict(vocab=64, d_model=192, n_heads=2, n_layers=2, d_ff=128),
       "d80_mqa": dict(vocab=64, d_model=160, n_heads=2, n_layers=2,
                       d_ff=128, n_kv_heads=1)}


@pytest.mark.parametrize("plan", ["ragged", "split"])
@pytest.mark.parametrize("lm", sorted(LMS))
def test_batcher_matches_tpulab(lm, plan):
    """Greedy tokens of three requests (lanes 2: one queues) through the
    port's batcher equal tpulab's, under the ragged and the split plan."""
    from tpulab_torch.models.convert import params_from_numpy

    cfg = LMS[lm]
    geo = dict(n_heads=cfg["n_heads"], n_layers=cfg["n_layers"], lanes=2,
               max_len=64, page_size=8,
               n_kv_heads=cfg.get("n_kv_heads"))
    jparams = jax_init(**cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu", n_heads=cfg["n_heads"])
    prompts = [np.random.default_rng(s).integers(0, 64, (5 + s,), np.int32)
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


# -------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_close(got, want):
    rtol, atol = CARD_TOL[str(got.dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_cuda_ragged_d16(q_dt, kv_dt):
    """Kernel 1's fma body at D 16 (the P.V's two key groups a warp)
    against its plain version, the idle lane and the rows past q_lens
    zeros, a second launch bit-identical."""
    dev = _card()
    q, pool, tables = _inputs(16, 4, 8, 2, 2, 16, 8, 4)
    args = (torch.from_numpy(q).to(dev, getattr(torch, q_dt)),
            torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
            torch.from_numpy(tables).to(dev),
            torch.tensor(RA_LENS[0], dtype=torch.int32, device=dev),
            torch.tensor(RA_LENS[1], dtype=torch.int32, device=dev))
    n0 = dict(ragged_paged_attention.launches_by_head_dim)
    got = ragged_paged_attention(*args)
    again = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches_by_head_dim[16] == \
        n0.get(16, 0) + 2
    assert torch.equal(got, again)
    _card_close(got, ragged_paged_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", Q_DTYPES)
@pytest.mark.parametrize("t", [1, 63, 64, 200])
def test_cuda_flash_d16(dtype, t):
    dev = _card()
    rng = np.random.default_rng(t)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, t, 3, 16)).astype(np.float32)).to(dev, getattr(torch, dtype))
        for _ in range(3))
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
        again = flash_attention(q, k, v, causal=causal, block_q=t,
                                block_k=t)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _card_close(got, flash_attention_reference(q, k, v, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_cuda_paged_small_dims(q_dt, kv_dt, d):
    dev = _card()
    for b, mp in ((4, 4), (2, 64)):      # one split, then several
        q, pool, tables = _inputs(d + b, b, 1, 2, 2, d, 8, mp)
        lengths = ([7, 8, 20, 0] if b == 4 else [8 * mp - 1, 100])
        args = (torch.from_numpy(q[:, 0]).to(dev, getattr(torch, q_dt)),
                torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
                torch.from_numpy(tables).to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev))
        got = paged_decode_attention(*args)
        again = paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _card_close(got, paged_decode_attention_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("hq,hkv", BIG_GROUPS + [(12, 1)])
def test_cuda_paged_big_groups(hq, hkv, d):
    """Groups past 8: blocks of 8 query heads (a last block of 4 at G
    12), bf16 over bf16 pages, one split and several."""
    dev = _card()
    for b, mp in ((2, 8), (1, 128)):
        q, pool, tables = _inputs(hq * d + b, b, 1, hq, hkv, d, 16, mp)
        args = (torch.from_numpy(q[:, 0]).to(dev, torch.bfloat16),
                torch.from_numpy(pool).to(dev, torch.bfloat16),
                torch.from_numpy(tables).to(dev),
                torch.tensor([16 * mp - 1] * b, dtype=torch.int32,
                             device=dev))
        got = paged_decode_attention(*args)
        torch.cuda.synchronize()
        _card_close(got, paged_decode_attention_reference(*args))
