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

The CUDA kernel has no CPU mode: its tests are marked ``cuda`` and skip
without a card (``chip_smoke.py`` holds it against the plain version on
the H100).  The card's machine has no JAX, so the reference imports are
optional there and only the ``cuda`` tests run:
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.
The split rule (:func:`paged_splits`) is plain Python and tested here.
"""

import inspect

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax.numpy as jnp

    from tpulab.ops.paged_attention import paged_decode_attention as tpu_pda
except ImportError:
    jnp = None
from tpulab_torch.ops import paged_attention as pa
from tpulab_torch.ops.paged_attention import (
    MAX_SPLITS, paged_decode_attention, paged_decode_attention_reference,
    paged_splits)
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


# ---------------------------------------------------------------- split rule
N_SM = 132          # an H100's SMs
SERVE = dict(hkv=8, mp=128, page_size=16)   # chip_smoke's geometry


def test_split_count_depends_on_shapes_only():
    """The split count takes shapes and the SM count, and no lengths:
    equal shapes give equal splits, so equal launches give equal bits."""
    assert list(inspect.signature(paged_splits).parameters) == [
        "b", "hkv", "mp", "page_size", "n_sm"]
    assert len({paged_splits(8, n_sm=N_SM, **SERVE) for _ in range(3)}) == 1


@pytest.mark.parametrize("b,hkv", [(32, 8), (17, 8), (132, 1), (8, 32)])
def test_one_split_when_blocks_fill_the_card(b, hkv):
    """(KV head, lane) blocks that already fill the SMs are not split."""
    assert paged_splits(b, hkv, 128, 16, N_SM) == 1


@pytest.mark.parametrize("b,mp,want", [(8, 64, 4), (8, 128, 4),
                                       (1, 128, 16), (1, 256, 16)])
def test_serving_decode_splits(b, mp, want):
    """8 lanes x 1024 positions (64 blocks for 132 SMs) split 4 ways, about
    two blocks an SM; one lane x 2048 (8 blocks) splits 16 ways."""
    n = paged_splits(b, 8, mp, 16, N_SM)
    assert n == want and n >= 2
    assert n * b * 8 <= 2 * N_SM       # one wave of two blocks an SM


@pytest.mark.parametrize("b", [1, 2, 8, 32])
@pytest.mark.parametrize("mp,page_size", [(1, 4), (2, 16), (8, 8), (5, 1),
                                          (128, 16)])
def test_splits_bounded_by_the_table_and_the_cap(b, mp, page_size):
    """Never more splits than 128-position rounds in ``mp * page_size``
    (each split keeps its four consumer warps busy) nor than the cap."""
    for hkv in (1, 2, 8):
        n = paged_splits(b, hkv, mp, page_size, N_SM)
        assert 1 <= n <= MAX_SPLITS
        assert n <= max(1, -(-mp * page_size // 128))


# ---------------------------------------------------------------- on the card
def _card_args(dtypes, lengths, b, mp, seed, g=4, hkv=8):
    """q and pool at D 128, pages of 16, scattered tables; every position
    past a lane's inclusive length (the tail of its last live page and
    every dead page) set to NaN (0x7F in an e4m3 pool)."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float8_e4m3fn": torch.float8_e4m3fn}
    s, d = 16, 128
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal(
        (b, hkv * g, d)).astype(np.float32)).to(dev, dt[dtypes[0]])
    pool = torch.from_numpy(rng.standard_normal(
        (b * mp + 1, 2, s, hkv, d)).astype(np.float32)).to(dev, dt[dtypes[1]])
    tables = torch.from_numpy((rng.permutation(b * mp) + 1).astype(
        np.int32).reshape(b, mp)).to(dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dead = torch.arange(mp * s, device=dev)[None] > lengths[:, None]
    lane, p = dead.nonzero(as_tuple=True)
    if pool.dtype == torch.float8_e4m3fn:    # e4m3's NaN code
        pool.view(torch.uint8)[tables[lane, p // s].long(), :, p % s] = 0x7F
    else:
        pool[tables[lane, p // s].long(), :, p % s] = float("nan")
    return q, pool, tables, lengths


def _check_on_card(args):
    """Two launches: bit-identical, finite, one count each, and equal to
    the plain version at the output dtype's tolerance (f32 1e-4; bf16
    rtol 8e-3, one last-place flip, atol 4e-3 near zero)."""
    n0 = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 2
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    want = paged_decode_attention_reference(*args)
    rtol, atol = ((8e-3, 4e-3) if got.dtype == torch.bfloat16
                  else (1e-4, 1e-4))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


_DTYPES = [("bfloat16", "bfloat16"), ("float32", "float32"),
           ("float32", "bfloat16"), ("bfloat16", "float8_e4m3fn"),
           ("float32", "float8_e4m3fn")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _DTYPES)
def test_cuda_kernel_matches_plain_version(dtypes):
    """On the card: the kernel against its plain version at lengths 0, 15
    and 16 (a page's last slot and the next page's first), 300 and 2047,
    with the tail of each last live page and every dead page poisoned with
    NaN, and a second launch bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _check_on_card(_card_args(dtypes, [0, 15, 16, 300, 2047], 5, 128, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _DTYPES)
@pytest.mark.parametrize("g", [1, 4, 8])
def test_cuda_one_lane_long_context(dtypes, g):
    """One lane over 2048 positions (16 splits on an H100) and 2040 (a
    page tail poisoned), GQA group 1, 4 and 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for pos in (2047, 2039):
        _check_on_card(_card_args(dtypes, [pos], 1, 128, 6 + g, g=g))


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", range(1, MAX_SPLITS + 1))
def test_cuda_every_split_count(n_split, monkeypatch):
    """Each split count the rule can give, forced on one shape whose lanes
    give some splits no live stage (length 0, 31, 32 beside 1000 and
    2047): neutral partials merge to the plain version's output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(pa, "paged_splits", lambda *a: n_split)
    _check_on_card(_card_args(("bfloat16", "bfloat16"),
                              [0, 31, 32, 1000, 2047], 5, 128, 7, hkv=2))


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", range(1, MAX_SPLITS + 1))
def test_cuda_every_split_count_over_e4m3_pages(n_split, monkeypatch):
    """The same forced split counts over an e4m3 pool, bf16 q: stages of
    half the bytes, the same 16-byte chunks, NaN page tails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(pa, "paged_splits", lambda *a: n_split)
    _check_on_card(_card_args(("bfloat16", "float8_e4m3fn"),
                              [0, 31, 32, 1000, 2047], 5, 128, 8, hkv=2))
