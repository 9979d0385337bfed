"""Every head dim that tpulab's flash kernel takes, on kernel 2 of the
port.

tpulab's ``_flash_bhd`` takes any head dim
(``tpulab/ops/flash_attention.py``).  The port runs bf16 and f16 at D 80,
96 and 112 on the tensor cores (the 128-wide tile; TMA fills the columns
past D with zeros) and every other dtype and D up to 256 on the fma body
(a padded width of 32, 64, 128 or 256, D taken at run time).  Here on the
CPU the wrapper takes its plain version, held against tpulab's Pallas
kernel in interpret mode on the same numpy inputs at D 24, 80, 96 and
112, causal and full, in f32, bf16 and f16.  Tolerances by the output
dtype, as ``tests/test_torch_head_dims.py`` holds them: f32 2e-5, bf16
2e-2, f16 2e-3.

The card's cases are marked ``cuda`` and skip without a card
(``python -m pytest --noconftest -m cuda
tests/test_torch_head_dims_flash.py``).
"""

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    from tpulab.ops.flash_attention import flash_attention as tpu_flash
except ImportError:
    tpu_flash = None
from test_torch_head_dims import Q_DTYPES, TOL, _q
from test_torch_head_dims_wide import _card, _card_close
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_body)

torch.set_num_threads(2)

FLASH_DIMS = (24, 80, 96, 112)


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("dtype", Q_DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_dims_match_tpulab(dtype, causal, d):
    rng = np.random.default_rng(d)
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


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 80, 96, 100, 112, 200])
@pytest.mark.parametrize("dtype", Q_DTYPES)
@pytest.mark.parametrize("t", [1, 63, 200])
def test_cuda_flash_wide_dims(dtype, t, d):
    """Contiguous and strided (a fused projection's views) q / k / v, causal
    and full: the body :func:`flash_body` names, bit-identical twice."""
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(t * d)
    contiguous = [torch.from_numpy(rng.standard_normal(
        (2, t, 3, d)).astype(np.float32)).to(dev, dt) for _ in range(3)]
    fused = torch.from_numpy(rng.standard_normal(
        (1, t, 9, d)).astype(np.float32)).to(dev, dt)
    strided = [fused[:, :, :3], fused[:, :, 3:6], fused[:, :, 6:]]
    body = flash_body(dt, d)
    for q, k, v in (contiguous, strided):
        for causal in (True, False):
            n0 = dict(flash_attention.launches_by_body)
            got = flash_attention(q, k, v, causal=causal, block_q=t,
                                  block_k=t)
            again = flash_attention(q, k, v, causal=causal, block_q=t,
                                    block_k=t)
            torch.cuda.synchronize()
            ran = {b: n - n0[b]
                   for b, n in flash_attention.launches_by_body.items()}
            assert ran == {b: 2 if b == body else 0 for b in ran}
            assert torch.equal(got, again)
            _card_close(got, flash_attention_reference(q, k, v, causal))
