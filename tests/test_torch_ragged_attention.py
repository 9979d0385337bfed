"""tpulab_torch ragged paged attention vs tpulab's Pallas kernel.

Here on the CPU the port's wrapper dispatches to its plain version
(``ragged_paged_attention_reference``), and tpulab's kernel runs in
Pallas interpret mode, as tpulab's own tests run it.  Both see the same
numpy inputs over the grid of ``tests/test_ragged_attention.py``: dtype x
page size {4, 8} x raggedness shape, plus the long walk and a q f32 /
bf16 pool mix.  Tolerances: f32 2e-5 (summation order differs); bf16
2e-2 (P.V rounds to bf16 at different points, output is bf16).

The CUDA kernel itself has no CPU mode: its tests are marked ``cuda``
and skip without a card (``chip_smoke.py`` holds it against the plain
version on the H100).  The card's machine has no JAX, so the reference
imports are optional there and only the ``cuda`` tests run:
``python -m pytest --noconftest -m cuda tests/test_torch_ragged_attention.py``
(``tests/conftest.py`` sets up JAX).  The host rules
(:func:`ragged_body`, :func:`ragged_splits`) are plain Python and tested
here.
"""

import inspect

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax.numpy as jnp

    from tpulab.ops.ragged_attention import \
        ragged_paged_attention as tpu_rpa
except ImportError:
    jnp = None
from tpulab_torch.engine.paged import ContinuousBatcher, _gather_attend
from tpulab_torch.ops.ragged_attention import (
    MAX_SPLITS, STAGE_KEYS, ragged_body, ragged_paged_attention,
    ragged_paged_attention_reference, ragged_splits)

torch.set_num_threads(2)

_DT = {"float32": (jnp and jnp.float32, torch.float32),
       "bfloat16": (jnp and jnp.bfloat16, torch.bfloat16),
       "float8_e4m3fn": (jnp and jnp.float8_e4m3fn, torch.float8_e4m3fn)}
E4M3 = torch.float8_e4m3fn
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _shape_case(name, s):
    """(q_lens, kv_lens) per shape, 4 lanes — tests/test_ragged_attention.py."""
    return {
        "all_decode": ([1, 1, 1, 0], [2 * s + 1, s, 3, 0]),
        "all_prefill": ([s + 3, 2 * s, 5, 3], [s + 3, 2 * s, 5, 3]),
        "mixed": ([1, s + 2, 5, 0], [2 * s, 2 * s + 2, s + 5, 0]),
        "verify": ([5, 5, 5, 5], [7, s + 5, 2 * s + 5, 3 * s]),
        "page_cross": ([4, 4, 1, 1], [s + 2, 2 * s, s + 1, s]),
    }[name]


def _inputs(seed, b, m, hq, hkv, d, s, mp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, m, hq, d)).astype(np.float32)
    pool = rng.standard_normal((b * mp + 1, 2, s, hkv, d)).astype(np.float32)
    tables = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    return q, pool, tables


def _both(q, pool, tables, q_lens, kv_lens, q_dt, kv_dt):
    want = tpu_rpa(jnp.asarray(q).astype(_DT[q_dt][0]),
                   jnp.asarray(pool).astype(_DT[kv_dt][0]),
                   jnp.asarray(tables), jnp.asarray(q_lens, jnp.int32),
                   jnp.asarray(kv_lens, jnp.int32))
    got = ragged_paged_attention(
        torch.from_numpy(q).to(_DT[q_dt][1]),
        torch.from_numpy(pool).to(_DT[kv_dt][1]),
        torch.from_numpy(tables), torch.tensor(q_lens, dtype=torch.int32),
        torch.tensor(kv_lens, dtype=torch.int32))
    return np.asarray(want, np.float32), got.float().numpy(), got.dtype


@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["all_decode", "all_prefill", "mixed",
                                   "verify", "page_cross"])
def test_plain_version_matches_tpulab_grid(shape, dtype, page_size):
    q_lens, kv_lens = _shape_case(shape, page_size)
    q, pool, tables = _inputs(page_size, 4, 2 * page_size, 4, 2, 16,
                              page_size, 4)
    want, got, out_dt = _both(q, pool, tables, q_lens, kv_lens, dtype, dtype)
    assert out_dt == _DT[dtype][1]
    for b, n in enumerate(q_lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n],
                                   rtol=_TOL[dtype], atol=_TOL[dtype])
        assert not got[b, n:].any()     # rows past q_len are zeros


def test_plain_version_long_walk():
    """A walk over 12 pages (tpulab's deep-pipeline regime)."""
    q, pool, tables = _inputs(3, 1, 3, 2, 2, 16, 4, 12)
    want, got, _ = _both(q, pool, tables, [3], [4 * 12 - 1],
                         "float32", "float32")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_version_f32_queries_over_bf16_pool():
    """Params f32 + compute bf16 gives f32 q over a bf16 pool."""
    q_lens, kv_lens = _shape_case("mixed", 8)
    q, pool, tables = _inputs(11, 4, 16, 4, 2, 16, 8, 4)
    want, got, out_dt = _both(q, pool, tables, q_lens, kv_lens,
                              "float32", "bfloat16")
    assert out_dt == torch.float32
    for b, n in enumerate(q_lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=2e-5,
                                   atol=2e-5)


def test_plain_version_never_reads_past_kv_len():
    """Positions >= kv_lens hold NaN: the output stays finite."""
    q, pool, tables = _inputs(5, 2, 4, 4, 2, 16, 4, 4)
    q_lens, kv_lens = [3, 1], [6, 9]
    pool_nan = pool.copy()
    for b, n in enumerate(kv_lens):
        for pos in range(n, 16):
            pool_nan[tables[b, pos // 4], :, pos % 4] = np.nan
    ref = ragged_paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(tables),
        torch.tensor(q_lens), torch.tensor(kv_lens))
    got = ragged_paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(pool_nan),
        torch.from_numpy(tables), torch.tensor(q_lens), torch.tensor(kv_lens))
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper's CPU dispatch is the plain version and launches (and
    counts) nothing."""
    q, pool, tables = _inputs(7, 4, 8, 4, 2, 16, 4, 4)
    q_lens, kv_lens = _shape_case("verify", 4)
    args = (torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(tables), torch.tensor(q_lens),
            torch.tensor(kv_lens))
    n0 = ragged_paged_attention.launches
    assert torch.equal(ragged_paged_attention(*args),
                       ragged_paged_attention_reference(*args))
    assert ragged_paged_attention.launches == n0


def test_gather_attend_matches_plain_version():
    """tpulab's dense-gather math (the paged programs' reference) and the
    kernel's plain version agree on every valid row."""
    q, pool, tables = _inputs(9, 4, 8, 4, 2, 16, 4, 4)
    q_lens, kv_lens = _shape_case("mixed", 4)
    qt = torch.from_numpy(q)
    pt = torch.from_numpy(pool)
    qpos = (torch.tensor(kv_lens) - torch.tensor(q_lens))[:, None] \
        + torch.arange(8)[None]
    gathered = _gather_attend(qt, pt[:, 0], pt[:, 1],
                              torch.from_numpy(tables), qpos, torch.float32)
    plain = ragged_paged_attention_reference(
        qt, pt, torch.from_numpy(tables), torch.tensor(q_lens),
        torch.tensor(kv_lens)).reshape(4, 8, -1)
    for b, n in enumerate(q_lens):
        torch.testing.assert_close(gathered[b, :n], plain[b, :n],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"),
                                    ("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float8_e4m3fn"),
                                    ("float32", "float8_e4m3fn")])
def test_cuda_kernel_matches_plain_version(dtypes):
    """On the card: the CUDA kernel against its plain version, with every
    launch counted.  The tolerance follows the OUTPUT dtype: f32 sums the
    same values in another order, 1e-4; bf16 also rounds P to bf16 before
    P V on the tensor cores, and both round the output to bf16: one
    last-place flip (rtol 8e-3) with atol 4e-3 near zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q_dt, kv_dt = (_DT[d][1] for d in dtypes)
    q_lens, kv_lens = _shape_case("mixed", 16)
    q, pool, tables = _inputs(1, 4, 32, 8, 2, 128, 16, 4)
    dev = torch.device("cuda")
    args = (torch.from_numpy(q).to(dev, q_dt),
            torch.from_numpy(pool).to(dev, kv_dt),
            torch.from_numpy(tables).to(dev),
            torch.tensor(q_lens, device=dev),
            torch.tensor(kv_lens, device=dev))
    n0 = ragged_paged_attention.launches
    got = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == n0 + 1
    want = ragged_paged_attention_reference(*args)
    rtol, atol = (8e-3, 4e-3) if q_dt == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------- host rules
N_SM = 132          # an H100's SMs
SERVE = dict(hq=32, hkv=8, mp=128, page_size=16)   # chip_smoke's serve


@pytest.mark.parametrize("q_dt,kv_dt,d,body", [
    ("bfloat16", "bfloat16", 128, "wgmma"),
    ("bfloat16", "bfloat16", 64, "wgmma"),
    ("bfloat16", "bfloat16", 256, "fma"),
    ("float32", "float32", 128, "fma"),
    ("float32", "bfloat16", 128, "fma"),
    ("bfloat16", "float32", 128, "fma"),
    ("bfloat16", "float8_e4m3fn", 128, "wgmma"),
    ("bfloat16", "float8_e4m3fn", 64, "wgmma"),
    ("bfloat16", "float8_e4m3fn", 256, "fma"),
    ("float32", "float8_e4m3fn", 128, "fma")])
def test_body_rule(q_dt, kv_dt, d, body):
    """Only bf16 q over a bf16 or e4m3 pool (D 64 or 128) goes to the
    tensor cores (e4m3 pages upcast to bf16 first, exactly); f32 products
    keep f32 FMAs (no TF32)."""
    assert ragged_body(getattr(torch, q_dt), getattr(torch, kv_dt), d) == body


def test_split_count_depends_on_shapes_only():
    """The split count takes shapes, the SM count and the body, and no
    lengths: equal shapes give equal splits, so equal launches give equal
    bits (the K-block equals chained steps)."""
    assert list(inspect.signature(ragged_splits).parameters) == [
        "b", "m", "hq", "hkv", "mp", "page_size", "n_sm", "body"]
    counts = {ragged_splits(8, 1, n_sm=N_SM, **SERVE) for _ in range(3)}
    assert len(counts) == 1


@pytest.mark.parametrize("m", [256, 100])
def test_one_split_when_tiles_fill_the_card(m):
    """A mixed round (up to 256 rows a lane) at the serving geometry has
    >= 132 blocks already: one pass writes the output directly."""
    assert ragged_splits(8, m, n_sm=N_SM, **SERVE) == 1


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("mp", [64, 128])
def test_decode_and_verify_split(m, mp):
    """8-lane decode (and K+1 = 5 verify) over 1024 or 2048 positions has
    64 blocks for 132 SMs: the context is split across blocks."""
    serve = dict(SERVE, mp=mp)
    n = ragged_splits(8, m, n_sm=N_SM, **serve)
    assert 1 < n <= MAX_SPLITS
    assert n * 8 * 8 <= 2 * N_SM      # about two blocks per SM, one wave


@pytest.mark.parametrize("b", [1, 2, 8, 32])
@pytest.mark.parametrize("mp,page_size", [(1, 4), (2, 16), (8, 8),
                                          (128, 16)])
def test_splits_fit_the_context(b, mp, page_size):
    """Never more splits than 64-key stages in ``mp * page_size``, and
    the CUDA-core body never splits."""
    for m in (1, 5, 16, 64, 256):
        n = ragged_splits(b, m, 32, 8, mp, page_size, N_SM)
        assert 1 <= n <= max(1, -(-mp * page_size // STAGE_KEYS))
        assert ragged_splits(b, m, 32, 8, mp, page_size, N_SM, "fma") == 1


# ---------------------------------------------------------------- on the card
# chip_smoke.py's seven shapes, then lanes with no query rows over a live
# context and over none: (q_lens, kv_lens) over 8 lanes x 128 pages
_CARD_CASES = {
    "all_decode": ([1] * 8, [1024] * 8),
    "all_prefill": ([256] * 8, [256] * 8),
    "chunk_over_ctx": ([256] * 8, [1024] * 8),
    "mixed": ([1, 256, 5, 0, 1, 100, 1, 17],
              [1024, 1280, 37, 0, 2000, 600, 16, 33]),
    "verify": ([5] * 8, [5, 21, 200, 512, 1024, 1500, 2000, 2048]),
    "page_cross": ([4, 4, 1, 1, 16, 16, 3, 2],
                   [18, 32, 17, 16, 48, 16, 33, 64]),
    "long_decode": ([1] * 8, [2048] * 8),
    "idle_lanes": ([0, 3, 1, 0, 40, 0, 1, 2],
                   [300, 40, 77, 0, 100, 1, 2000, 2]),
}


def _poison(pool, pages, slots):
    """NaN into the rows (pages, slots) of K and V."""
    if pool.dtype == E4M3:
        pool.view(torch.uint8)[pages, :, slots] = 0x7F
    else:
        pool[pages, :, slots] = float("nan")


def _card_inputs(case, g, seed):
    return _nan_inputs(*_CARD_CASES[case], g, seed)


def _nan_inputs(q_lens, kv_lens, g, seed, q_dt=torch.bfloat16,
                kv_dt=torch.bfloat16):
    """q and pool (bf16 by default) at a small width (Hkv 2, D 128, G query
    heads per KV head), scattered tables, and every position a lane does
    not hold set to NaN (a dead page must never be read; in an e4m3 pool
    the NaN code 0x7F)."""
    b, mp, s, hkv, d = 8, 128, 16, 2, 128
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    pool = torch.from_numpy(rng.standard_normal(
        (b * mp + 1, 2, s, hkv, d)).astype(np.float32)).to(dev, kv_dt)
    tables = torch.from_numpy((rng.permutation(b * mp) + 1).astype(
        np.int32).reshape(b, mp)).to(dev)
    pos = torch.arange(mp * s, device=dev)
    dead = pos[None] >= torch.tensor(kv_lens, device=dev)[:, None]
    lane, p = dead.nonzero(as_tuple=True)
    _poison(pool, tables[lane, p // s].long(), p % s)
    q = torch.from_numpy(rng.standard_normal(
        (b, max(q_lens), hkv * g, d)).astype(np.float32)).to(dev, q_dt)
    return (q, pool, tables, torch.tensor(q_lens, device=dev),
            torch.tensor(kv_lens, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("case", list(_CARD_CASES))
def test_cuda_wgmma_body_over_the_smoke_cases(case, g):
    """On the card, bf16: each of chip_smoke.py's shapes, and lanes with
    no query rows (over a live context and over none), at a small width
    and GQA group 1, 4 or 8 (a group of 4 splits over 16 positions a
    tile), with NaN in every position past a lane's length, runs the
    tensor-core body (split-KV where the tiles do not fill the card),
    matches the plain version (rtol 8e-3, atol 4e-3: P and the output
    rounded to bf16) and gives the same bits on a second launch; rows
    past q_len and a lane with kv_len 0 are zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _card_inputs(case, g, seed=g)
    n0 = dict(ragged_paged_attention.launches_by_body)
    got = ragged_paged_attention(*args)
    again = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ran = {k: n - n0[k]
           for k, n in ragged_paged_attention.launches_by_body.items()}
    assert ran == {"fma": 0, "wgmma": 2}
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    want = ragged_paged_attention_reference(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=4e-3)
    for lane, n in enumerate(_CARD_CASES[case][0]):
        assert not got[lane, n:].any()


def _verify_lens(k):
    """(q_lens, kv_lens) of a speculative verify forward at draft length
    ``k``: windows of k+1 rows, three of them crossing a page boundary
    (kv_lens 16c + k//2 + 1 put the window's start in page c-1), one at
    the start of a context, one at 2048, and two lanes with no rows (one
    over a live context, one over none)."""
    w = k + 1
    return ([w, 0, w, w, 0, w, w, w],
            [w, 300, 48 + k // 2 + 1, 1024 + k // 2 + 1, 0, 2048,
             16 + k // 2 + 1, 700])


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"),
                                    ("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float8_e4m3fn"),
                                    ("float32", "float8_e4m3fn")])
@pytest.mark.parametrize("k", ContinuousBatcher.BLOCK_K_MENU)
def test_cuda_kernel_at_verify_shapes(k, dtypes):
    """On the card: the kernel at the speculative verify shape q = K+1 for
    every K of the block menu, GQA group 4, in every dtype mix, with NaN
    past each lane's length, against the plain version (f32 1e-4; bf16
    rtol 8e-3, atol 4e-3) and bit-identical on a second launch; rows past
    q_len and the lanes with no rows are zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q_dt, kv_dt = (_DT[d][1] for d in dtypes)
    q_lens, kv_lens = _verify_lens(k)
    args = _nan_inputs(q_lens, kv_lens, 4, seed=k, q_dt=q_dt, kv_dt=kv_dt)
    got = ragged_paged_attention(*args)
    again = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.isfinite(got).all()
    want = ragged_paged_attention_reference(*args)
    rtol, atol = (8e-3, 4e-3) if q_dt == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    for lane, n in enumerate(q_lens):
        assert not got[lane, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("case", list(_CARD_CASES))
def test_cuda_wgmma_body_over_e4m3_pages(case, g):
    """On the card, bf16 q over an e4m3 pool: each smoke shape and the idle
    lanes, GQA group 1, 4 or 8, with 0x7F (NaN) in every position past a
    lane's length, runs the tensor-core body (the pages staged raw and
    upcast to bf16 in shared memory), matches the plain version over the
    same bytes (rtol 8e-3, atol 4e-3: P and the output rounded to bf16)
    and gives the same bits on a second launch; rows past q_len and a
    lane with kv_len 0 are zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _nan_inputs(*_CARD_CASES[case], g, seed=10 + g, kv_dt=E4M3)
    n0 = dict(ragged_paged_attention.launches_by_body)
    got = ragged_paged_attention(*args)
    again = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ran = {k: n - n0[k]
           for k, n in ragged_paged_attention.launches_by_body.items()}
    assert ran == {"fma": 0, "wgmma": 2}
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    want = ragged_paged_attention_reference(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=4e-3)
    for lane, n in enumerate(_CARD_CASES[case][0]):
        assert not got[lane, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", range(1, MAX_SPLITS + 1))
def test_cuda_every_split_count_over_e4m3_pages(n_split, monkeypatch):
    """Each split count forced on the decode and verify shapes over an
    e4m3 pool (lanes whose context some splits never reach: kv_len 1, 16,
    17 beside 2048): the partials merge to the plain version's output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from tpulab_torch.ops import ragged_attention as ra

    monkeypatch.setattr(ra, "ragged_splits", lambda *a: n_split)
    for q_lens in ([1] * 8, [3, 1, 3, 3, 3, 3, 0, 3]):
        kv_lens = [1, 16, 17, 64, 300, 1024, 2000, 2048]
        args = _nan_inputs(q_lens, kv_lens, 4, seed=n_split, kv_dt=E4M3)
        got = ragged_paged_attention(*args)
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.isfinite(got).all()
        want = ragged_paged_attention_reference(*args)
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                                   atol=4e-3)
