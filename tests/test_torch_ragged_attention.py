"""tpulab_torch ragged paged attention vs tpulab's Pallas kernel.

Here on the CPU the port's wrapper dispatches to its plain version
(``ragged_paged_attention_reference``), and tpulab's kernel runs in
Pallas interpret mode, as tpulab's own tests run it.  Both see the same
numpy inputs over the grid of ``tests/test_ragged_attention.py``: dtype x
page size {4, 8} x raggedness shape, plus the long walk and a q f32 /
bf16 pool mix.  Tolerances: f32 2e-5 (summation order differs); bf16
2e-2 (P.V rounds to bf16 at different points, output is bf16).

The CUDA kernel itself has no CPU mode: its test is marked ``cuda`` and
skips without a card (``chip_smoke.py`` holds it against the plain
version on the H100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.ops.ragged_attention import ragged_paged_attention as tpu_rpa
from tpulab_torch.engine.paged import _gather_attend
from tpulab_torch.ops.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_reference)

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
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
                                    ("float32", "bfloat16")])
def test_cuda_kernel_matches_plain_version(dtypes):
    """On the card: the CUDA kernel against its plain version, with every
    launch counted.  Both sum the same values in f32, so the tolerance
    follows the OUTPUT dtype: f32 1e-4; bf16 one last-place flip of the
    final rounding (rtol 8e-3) with atol 4e-3 near zero."""
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
