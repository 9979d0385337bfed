"""Every head dim that tpulab's kernels take, on kernel 1 of the port.

tpulab's ragged kernel takes the head dim as a parameter, so any D
(``tpulab/ops/ragged_attention.py``; its flash and paged kernels too:
``tests/test_torch_head_dims_flash.py``, ``..._paged.py``);
public Llama-architecture models use D 80 (Phi-2's 32 heads of 2560), 96
(Phi-3-mini's 32 of 3072) and others.  The port builds every D from 1 to
256: the 16-bit pairs at D 80, 96 and 112 on the tensor cores (the
128-wide tile with its columns past D zero), every other mix and D on the
fma bodies (a padded width of 32, 64, 128 or 256 with D taken at run
time).  Here on the CPU each wrapper takes its plain version, held
against tpulab's Pallas kernel in interpret mode on the same numpy inputs
(pages cast by tpulab and carried over as bytes) at D 8, 24, 80, 96, 100
and 112 for every (q, page) pair.  Tolerances by the output dtype, as
``tests/test_torch_head_dims.py`` holds them: f32 2e-5, bf16 2e-2, f16
2e-3.

The card's forms have no CPU mode: their cases are marked ``cuda`` and
skip without a card; there each form is held against its plain version
and relaunched bit for bit (``python -m pytest --noconftest -m cuda
tests/test_torch_head_dims_wide.py``; the card's machine has no JAX, so
the reference imports are optional).
"""

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax.numpy as jnp

    from tpulab.ops.ragged_attention import \
        ragged_paged_attention as tpu_rpa
except ImportError:
    jnp = None
from test_torch_head_dims import (CARD_TOL, PAIRS, RA_LENS, TOL, _inputs,
                                  _pool, _q)
from tpulab_torch.ops.ragged_attention import (
    MAX_SPLITS, ragged_body, ragged_paged_attention,
    ragged_paged_attention_reference)

torch.set_num_threads(2)

#: head dims held against tpulab: below 16 (8), an fp8 row that is not
#: 16 bytes (24), Phi-2's 80, Phi-3-mini's 96, a bf16 row that is not 16
#: bytes (100), and 112
WIDE_DIMS = (8, 24, 80, 96, 100, 112)


# ------------------------------------------------------------- kernel 1
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_ragged_wide_dims_match_tpulab(q_dt, kv_dt, d):
    """Decode, a chunk over context, verify rows and an idle lane, GQA 4
    over 2."""
    q, pool, tables = _inputs(d, 4, 8, 4, 2, d, 8, 4)
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


#: (q_lens, kv_lens) at 8 lanes over 72 pages of 16: decode at a page
#: boundary and mid-page, verify rows, a chunk, an idle lane, long context
CARD_LENS = ([1, 1, 9, 64, 0, 1, 3, 17], [16, 17, 1033, 200, 0, 1024, 40,
                                           17])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 48, 80, 96, 100, 112, 200])
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_cuda_ragged_wide_dims(q_dt, kv_dt, d):
    """Each body (``wgmma`` on the 128-wide tile at 80 / 96 / 112 for the
    16-bit pairs, ``fma`` on a padded width elsewhere) against its plain
    version, rows past q_lens zeros, a second launch bit-identical."""
    dev = _card()
    q, pool, tables = _inputs(d + 7, 8, 64, 4, 2, d, 16, 72)
    q_dtype, kv_dtype = getattr(torch, q_dt), getattr(torch, kv_dt)
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(pool).to(dev).to(kv_dtype),
            torch.from_numpy(tables).to(dev),
            torch.tensor(CARD_LENS[0], dtype=torch.int32, device=dev),
            torch.tensor(CARD_LENS[1], dtype=torch.int32, device=dev))
    body = ragged_body(q_dtype, kv_dtype, d)
    n0 = dict(ragged_paged_attention.launches_by_body)
    got = ragged_paged_attention(*args)
    again = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ran = {b: n - n0[b]
           for b, n in ragged_paged_attention.launches_by_body.items()}
    assert ran == {b: 2 if b == body else 0 for b in ran}
    assert torch.equal(got, again)
    _card_close(got, ragged_paged_attention_reference(*args))
    for lane, n in enumerate(CARD_LENS[0]):
        assert not got[lane, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96, 112])
@pytest.mark.parametrize("n_split", [1, 3, MAX_SPLITS])
def test_cuda_ragged_wgmma_wide_split_counts(d, n_split, monkeypatch):
    """The tensor-core body at D 80 / 96 / 112 with split counts forced
    (the merge kernel at a head dim of the 128-wide tile), bf16 over bf16
    and f16 over e5m2 pages."""
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
