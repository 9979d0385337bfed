"""tpulab_torch paged decode attention vs tpulab's Pallas kernel.

Here on the CPU the port's wrapper takes its plain version
(``paged_decode_attention_reference``), and tpulab's kernel runs in
Pallas interpret mode, as ``tests/test_ops.py`` runs it.  Both see the
same numpy inputs: MHA and GQA pools, lengths on page boundaries
(``lengths`` is the inclusive current position), walks longer than
tpulab's DMA pipeline, and dead pages poisoned with inf / NaN.
Tolerances: f32 2e-5 (summation order differs); the poisoned cases
1e-6 (tpulab's own: the output must be exactly the live page's value);
bf16 2e-2 (output rounding to bf16).

The CUDA kernel has no CPU mode: its test is marked ``cuda`` and skips
without a card (``chip_smoke.py`` holds it against the plain version on
the H100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.ops.paged_attention import paged_decode_attention as tpu_pda
from tpulab_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from tpulab_torch.ops.ragged_attention import \
    ragged_paged_attention_reference

torch.set_num_threads(2)


def _inputs(seed, b, hq, hkv, d, s, mp):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    pool = rng.standard_normal((b * mp + 1, 2, s, hkv, d)).astype(np.float32)
    tables = (1 + np.arange(b * mp, dtype=np.int32)).reshape(b, mp)
    return q, pool, tables


def _both(q, pool, tables, lengths, dtype="float32", **tpu_kw):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = tpu_pda(jnp.asarray(q).astype(jdt), jnp.asarray(pool).astype(jdt),
                   jnp.asarray(tables), jnp.asarray(lengths, jnp.int32),
                   **tpu_kw)
    got = paged_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(pool).to(tdt),
        torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32))
    assert got.dtype == tdt and got.shape == q.shape
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2)])
def test_matches_tpulab_on_page_boundaries(hq, hkv):
    """Lengths on and around page starts (16 = 2 * page_size is the first
    slot of a fresh page), MHA and GQA."""
    q, pool, tables = _inputs(0, 5, hq, hkv, 16, 8, 3)
    want, got = _both(q, pool, tables, [20, 16, 15, 0, 23])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_matches_tpulab_past_the_pipeline_depth():
    """19 pages in blocks of 2 with 4 slots: more blocks than tpulab's
    DMA pipeline holds (the port walks the same positions in its own
    tiles)."""
    q, pool, tables = _inputs(1, 2, 2, 2, 16, 4, 19)
    want, got = _both(q, pool, tables, [19 * 4 - 2, 4 * 4 + 1],
                      g_pages=2, nbuf=4)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_matches_tpulab_bf16():
    q, pool, tables = _inputs(2, 3, 8, 2, 16, 8, 4)
    want, got = _both(q, pool, tables, [31, 7, 12], dtype="bfloat16")
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("poison", ["inf_nan", "large"])
def test_dead_pages_never_leak(poison):
    """A dead page inside the walked table (tpulab's poisoned block cases):
    the output is exactly the live page's V, on both sides."""
    b, h, d, s = 1, 2, 8, 4
    q = np.ones((b, h, d), np.float32)
    pool = np.zeros((6, 2, s, h, d), np.float32)
    pool[1, 1] = 5.0                          # live page: V = 5
    if poison == "inf_nan":
        pool[2, 0], pool[2, 1] = np.inf, np.nan
    else:
        pool[2, 0], pool[2, 1] = 1e6, -1e6
    tables = np.asarray([[1, 2, 3, 0]], np.int32)
    want, got = _both(q, pool, tables, [2], g_pages=4, nbuf=2)
    np.testing.assert_allclose(want, 5.0, rtol=1e-6)
    np.testing.assert_allclose(got, 5.0, rtol=1e-6)


def test_inclusive_lengths_equal_ragged_counts():
    """The convention: position ``lengths[b]`` inclusive here is the
    ragged family's decode shape with ``kv_lens = lengths + 1``."""
    q, pool, tables = _inputs(3, 4, 8, 2, 16, 4, 5)
    lengths = torch.tensor([0, 3, 4, 19])
    got = paged_decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(pool),
        torch.from_numpy(tables), lengths)
    ragged = ragged_paged_attention_reference(
        torch.from_numpy(q)[:, None], torch.from_numpy(pool),
        torch.from_numpy(tables), torch.ones(4, dtype=torch.int32),
        lengths + 1)[:, 0]
    torch.testing.assert_close(got, ragged, rtol=2e-6, atol=2e-6)


def test_cpu_tensors_take_the_plain_version():
    q, pool, tables = _inputs(4, 2, 4, 2, 16, 4, 3)
    args = (torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(tables), torch.tensor([5, 11]))
    n0 = paged_decode_attention.launches
    assert torch.equal(paged_decode_attention(*args),
                       paged_decode_attention_reference(*args))
    assert paged_decode_attention.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"),
                                    ("float32", "float32"),
                                    ("float32", "bfloat16")])
def test_cuda_kernel_matches_plain_version(dtypes):
    """On the card: the kernel against its plain version with a dead page
    poisoned with NaN, a launch counted.  Tolerance by output dtype, as
    for the ragged kernel: f32 1e-4; bf16 rtol 8e-3, atol 4e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    q, pool, tables = _inputs(5, 4, 32, 8, 128, 16, 20)
    lengths = [0, 15, 16, 300]
    pool[tables[1, 1]] = np.nan               # past lane 1's position 15
    dev = torch.device("cuda")
    args = (torch.from_numpy(q).to(dev, dt[dtypes[0]]),
            torch.from_numpy(pool).to(dev, dt[dtypes[1]]),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))
    n0 = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    want = paged_decode_attention_reference(*args)
    assert torch.isfinite(got).all()
    rtol, atol = ((8e-3, 4e-3) if dtypes[0] == "bfloat16" else (1e-4, 1e-4))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
