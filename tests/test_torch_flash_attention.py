"""tpulab_torch flash attention vs tpulab's Pallas kernel.

Here on the CPU the port's wrapper takes its plain version
(``flash_attention_reference``), and tpulab's kernel runs in Pallas
interpret mode, as ``tests/test_ops.py`` runs it.  Both see the same
numpy inputs.  Tolerances: f32 2e-5 (summation order differs); bf16
3e-2 (tpulab's own for bf16 inputs and outputs); gradients 2e-3 (tpulab's
backward test); logits of a transformer with flash attention 2e-4.

The CUDA kernel has no CPU mode: its test is marked ``cuda`` and skips
without a card (``chip_smoke.py`` holds it against the plain version on
the H100).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.models.transformer import init_transformer_params
from tpulab.models.transformer import transformer_apply as jax_apply
from tpulab.ops.flash_attention import flash_attention as tpu_flash
from tpulab.ops.flash_attention import \
    make_flash_attention_fn as tpu_make_flash
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.models.transformer import transformer_apply
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              make_flash_attention_fn)

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, b=2, t=128, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _both(arrs, dtype, causal, **blocks):
    jdt, tdt = _DT[dtype]
    want = tpu_flash(*(jnp.asarray(a).astype(jdt) for a in arrs),
                     causal=causal, **blocks)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                          causal=causal, **blocks)
    return np.asarray(want, np.float32), got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_tpulab(causal, dtype):
    want, got = _both(_qkv(0), dtype, causal, block_q=64, block_k=64)
    assert got.dtype == _DT[dtype][1] and got.shape == (2, 128, 2, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=_TOL[dtype],
                               atol=_TOL[dtype])


def test_short_sequence_blocks_clamp():
    """T = 8 (a 5-token prompt's pow2 bucket): blocks clamp to 8."""
    want, got = _both(_qkv(1, t=8), "float32", True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_uneven_blocks_rejected():
    arrs = [torch.from_numpy(a) for a in _qkv(2, t=96)]
    with pytest.raises(ValueError, match="divide"):
        flash_attention(*arrs, block_q=64, block_k=64)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper's CPU dispatch is the plain version and launches (and
    counts) nothing."""
    arrs = [torch.from_numpy(a) for a in _qkv(3, t=32)]
    n0 = flash_attention.launches
    assert torch.equal(flash_attention(*arrs), flash_attention_reference(*arrs))
    assert flash_attention.launches == n0


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_tpulab(causal):
    """The blockwise-recompute backward (block 16 at T = 64) against
    ``jax.grad`` through tpulab's custom VJP, f32."""
    arrs = _qkv(4, b=2, t=64, h=2, d=16)

    def loss_j(args):
        return (tpu_flash(*args, causal=causal, block_q=16,
                          block_k=16) ** 2).sum()

    want = jax.grad(loss_j)(tuple(jnp.asarray(a) for a in arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (flash_attention(*ts, causal=causal, block_q=16,
                     block_k=16) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


def test_attention_fn_in_transformer():
    """``make_flash_attention_fn`` as ``transformer_apply``'s attention,
    against tpulab's with its flash, same weights (bridge), f32."""
    pj = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                 n_layers=2, d_ff=64)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu",
                              n_heads=2)
    tokens = np.random.default_rng(5).integers(0, 64, (2, 128), np.int32)
    want = partial(jax_apply, n_heads=2, n_layers=2,
                   compute_dtype=jnp.float32,
                   attention_fn=tpu_make_flash(block_q=64, block_k=64))(
        pj, {"tokens": tokens})["logits"]
    got = transformer_apply(
        model.params, {"tokens": torch.from_numpy(tokens).long()},
        n_heads=2, n_layers=2, compute_dtype=torch.float32,
        attention_fn=make_flash_attention_fn(block_q=64,
                                             block_k=64))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [8, 200, 256])
def test_cuda_kernel_matches_plain_version(dtype, t):
    """On the card: the kernel against its plain version, causal and not,
    a launch counted per call.  Both sum the same values in f32, so the
    tolerance follows the output dtype: f32 1e-4; bf16 one last-place
    flip of the final rounding (rtol 8e-3) with atol 4e-3 near zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    arrs = [torch.from_numpy(a).to(dev, _DT[dtype][1])
            for a in _qkv(6, b=1, t=t, h=4, d=128)]
    rtol, atol = (8e-3, 4e-3) if dtype == "bfloat16" else (1e-4, 1e-4)
    for causal in (True, False):
        n0 = flash_attention.launches
        got = flash_attention(*arrs, causal=causal, block_q=t, block_k=t)
        torch.cuda.synchronize()
        assert flash_attention.launches == n0 + 1
        want = flash_attention_reference(*arrs, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
