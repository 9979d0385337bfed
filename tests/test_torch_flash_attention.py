"""tpulab_torch flash attention vs tpulab's Pallas kernel.

Here on the CPU the port's wrapper takes its plain version
(``flash_attention_reference``), and tpulab's kernel runs in Pallas
interpret mode, as ``tests/test_ops.py`` runs it.  Both see the same
numpy inputs.  Tolerances: f32 2e-5 (summation order differs); bf16
3e-2 (tpulab's own for bf16 inputs and outputs); gradients 2e-3 (tpulab's
backward test); logits of a transformer with flash attention 2e-4.

The CUDA kernel has no CPU mode: its tests are marked ``cuda`` and skip
without a card (``chip_smoke.py`` holds it against the plain version on
the H100).  The card's machine has no JAX, so the reference imports are
optional there and only the ``cuda`` tests run:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``
(``tests/conftest.py`` sets up JAX).
The body rule (:func:`flash_body`) is plain Python and tested here.
"""

from functools import partial

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax
    import jax.numpy as jnp

    from tpulab.models.transformer import init_transformer_params
    from tpulab.models.transformer import transformer_apply as jax_apply
    from tpulab.ops.flash_attention import flash_attention as tpu_flash
    from tpulab.ops.flash_attention import \
        make_flash_attention_fn as tpu_make_flash
except ImportError:
    jax = jnp = None
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.models.transformer import transformer_apply
from tpulab_torch.ops.flash_attention import (flash_attention,
                                              flash_attention_reference,
                                              flash_body,
                                              make_flash_attention_fn)

torch.set_num_threads(2)

_DT = {"float32": (jnp and jnp.float32, torch.float32),
       "bfloat16": (jnp and jnp.bfloat16, torch.bfloat16)}
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


@pytest.mark.parametrize("dtype,d,body", [
    ("bfloat16", 128, "wgmma"), ("bfloat16", 64, "wgmma"),
    ("bfloat16", 256, "wgmma"), ("float32", 128, "fma"),
    ("float32", 64, "fma"), ("float32", 256, "fma")])
def test_body_rule(dtype, d, body):
    """bf16 with D 64, 128 or 256 runs on the tensor cores (D 256 on the
    256-wide tile since Gemma-width serves); f32 (no TF32) keeps the
    CUDA-core body."""
    assert flash_body(getattr(torch, dtype), d) == body


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [8, 200, 256])
def test_cuda_kernel_matches_plain_version(dtype, t):
    """On the card: the kernel against its plain version, causal and not,
    a launch counted per call.  f32 sums the same values as the plain
    version in another order: 1e-4.  bf16 also rounds P to bf16 before
    P V on the tensor cores, and both round the output to bf16: one
    last-place flip (rtol 8e-3) with atol 4e-3 near zero."""
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


_CARD_TS = [1, 8, 63, 64, 65, 200, 2048]


def _strided_qkv(seed, t, h, d, dtype):
    """q, k, v as strided (B, T, H, D) views of one fused projection, as
    the transformer hands them over."""
    rng = np.random.default_rng(seed)
    fused = torch.from_numpy(rng.standard_normal(
        (1, t, 3 * h, d)).astype(np.float32)).to("cuda", dtype)
    return fused[:, :, :h], fused[:, :, h:2 * h], fused[:, :, 2 * h:]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", _CARD_TS)
def test_cuda_bodies_on_strided_views(t, d):
    """On the card, bf16: strided q/k/v views at every ragged edge (T
    below, at and past one 64-row tile, not a multiple of it, and the
    serve's largest bucket), causal and not.  Each call runs the body
    :func:`flash_body` names and a second launch is bit-identical.
    Tolerance as in the test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h = 8 if t == 2048 else 4
    q, k, v = _strided_qkv(t * d, t, h, d, torch.bfloat16)
    body = flash_body(torch.bfloat16, d)
    assert body == "wgmma"
    for causal in (True, False):
        n0 = dict(flash_attention.launches_by_body)
        got = flash_attention(q, k, v, causal=causal, block_q=t, block_k=t)
        again = flash_attention(q, k, v, causal=causal, block_q=t,
                                block_k=t)
        torch.cuda.synchronize()
        ran = {b: n - n0[b] for b, n in flash_attention.launches_by_body.items()}
        assert ran == {b: 2 if b == body else 0 for b in ran}
        assert torch.equal(got, again)
        want = flash_attention_reference(q, k, v, causal=causal)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                                   atol=4e-3)
