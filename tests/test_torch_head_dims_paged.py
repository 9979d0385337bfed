"""Every head dim that tpulab's paged decode kernel takes, on kernel 3 of
the port.

tpulab's ``_paged_attn`` takes any head dim
(``tpulab/ops/paged_attention.py``).  The port's one body is compiled for
D 16, 32, 64, 128 and 256 exactly and runs any other D up to 256 on the
next padded width of 32, 64, 128 and 256 with D taken at run time.  Here
on the CPU the wrapper takes its plain version, held against tpulab's
Pallas kernel in interpret mode on the same numpy inputs (pages cast by
tpulab and carried over as bytes) at D 8, 24, 80, 96, 100 and 112 for
every (q, page) pair.  Tolerances by the output dtype, as
``tests/test_torch_head_dims.py`` holds them: f32 2e-5, bf16 2e-2, f16
2e-3.

The card's cases are marked ``cuda`` and skip without a card
(``python -m pytest --noconftest -m cuda
tests/test_torch_head_dims_paged.py``).
"""

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax.numpy as jnp

    from tpulab.ops.paged_attention import \
        paged_decode_attention as tpu_pda
except ImportError:
    jnp = None
from test_torch_head_dims import (BIG_GROUPS, CARD_TOL, PAIRS, PD_LENGTHS,
                                  TOL, _inputs, _pool, _q)
from test_torch_head_dims_wide import WIDE_DIMS
from tpulab_torch.ops.paged_attention import (paged_decode_attention,
                                              paged_decode_attention_reference,
                                              paged_splits)
from tpulab_torch.ops.ragged_attention import _sm_count

torch.set_num_threads(2)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_paged_wide_dims_match_tpulab(q_dt, kv_dt, d):
    """GQA 4 over 2; positions on a page boundary, past the first page,
    0."""
    q, pool, tables = _inputs(d + 1, 4, 1, 4, 2, d, 8, 4)
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


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 24, 48, 80, 96, 100, 112, 200])
@pytest.mark.parametrize("q_dt,kv_dt", PAIRS)
def test_cuda_paged_wide_dims(q_dt, kv_dt, d):
    """One split (4 lanes), then several (2 lanes over 64 pages); a
    second launch bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for b, mp in ((4, 4), (2, 64)):
        q, pool, tables = _inputs(d + b, b, 1, 4, 2, d, 8, mp)
        lengths = PD_LENGTHS if b == 4 else [8 * mp - 1, 100]
        args = (torch.from_numpy(q[:, 0]).to(dev, getattr(torch, q_dt)),
                torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
                torch.from_numpy(tables).to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev))
        got = paged_decode_attention(*args)
        again = paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.isfinite(got).all()
        rtol, atol = CARD_TOL[q_dt]
        torch.testing.assert_close(
            got.float(), paged_decode_attention_reference(*args).float(),
            rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96, 100])
@pytest.mark.parametrize("hq,hkv", BIG_GROUPS + [(32, 32)])
def test_cuda_paged_wide_dims_groups(hq, hkv, d):
    """MHA at Phi-3-mini's and Phi-2's 32 heads, G 16 and MQA, bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for b, mp in ((2, 8), (1, 128)):
        q, pool, tables = _inputs(hq * d + b, b, 1, hq, hkv, d, 16, mp)
        args = (torch.from_numpy(q[:, 0]).to(dev, torch.bfloat16),
                torch.from_numpy(pool).to(dev, torch.bfloat16),
                torch.from_numpy(tables).to(dev),
                torch.tensor([16 * mp - 1] * b, dtype=torch.int32,
                             device=dev))
        got = paged_decode_attention(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(), paged_decode_attention_reference(*args).float(),
            rtol=8e-3, atol=4e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 25, 75, 255])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("q_dt,kv_dt", [("float32", "float32"),
                                        ("bfloat16", "bfloat16")])
def test_cuda_paged_odd_dims_odd_splits(q_dt, kv_dt, h, d):
    """An odd head dim over an odd count of split rows (one lane, Hq =
    Hkv = 1 or 3, 384 positions: three splits), so the O partials end on
    an odd float and the (m, l) pairs after them must still be aligned; a
    second launch bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    n_split = paged_splits(1, h, 48, 8, _sm_count(dev.index or 0))
    assert n_split > 1 and n_split * h * d % 2 == 1
    q, pool, tables = _inputs(d + h, 1, 1, h, h, d, 8, 48)
    args = (torch.from_numpy(q[:, 0]).to(dev, getattr(torch, q_dt)),
            torch.from_numpy(pool).to(dev).to(getattr(torch, kv_dt)),
            torch.from_numpy(tables).to(dev),
            torch.tensor([383], dtype=torch.int32, device=dev))
    got = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.isfinite(got).all()
    rtol, atol = CARD_TOL[q_dt]
    torch.testing.assert_close(
        got.float(), paged_decode_attention_reference(*args).float(),
        rtol=rtol, atol=atol)
