"""tpulab_torch transformer vs tpulab's, through the weight bridge.

The same weights (made by tpulab from a seed, carried over bit for bit
by ``params_from_numpy``) and the same tokens (numpy seed) go through
``tpulab.models.transformer.transformer_apply`` and the port's; the
logits must agree.  Tolerances: 1e-4 when everything is f32 (the two
backends sum in different orders); 3e-2 when bf16 is involved (bf16
keeps 8 mantissa bits and the two frameworks round intermediates to it
at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.models.transformer import (init_transformer_params,
                                       transformer_apply)
from tpulab_torch.models import transformer as tt
from tpulab_torch.models.convert import params_from_numpy, tree_from_numpy

torch.set_num_threads(2)

VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF, T = 96, 32, 4, 2, 48, 9
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_params(n_kv, ffn, tied, param_dtype):
    p = init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                seed=3, n_kv_heads=n_kv, ffn=ffn,
                                tie_embeddings=tied)
    return jax.tree_util.tree_map(lambda a: a.astype(_DT[param_dtype][0]), p)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("ffn,tied", [("gelu", True), ("swiglu", False)])
@pytest.mark.parametrize("rope", [None, 10000.0])
@pytest.mark.parametrize("n_kv", [N_HEADS, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_logits_match_tpulab(compute, param_dtype, n_kv, rope, ffn, tied):
    p = _jax_params(n_kv, ffn, tied, param_dtype)
    tokens = np.random.default_rng(1).integers(0, VOCAB, (2, T), np.int32)
    want = np.asarray(transformer_apply(
        p, {"tokens": jnp.asarray(tokens)}, n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=_DT[compute][0], n_kv_heads=n_kv,
        rope_theta=rope)["logits"])
    model = params_from_numpy(_np_tree(p), "cpu", n_heads=N_HEADS,
                              n_kv_heads=n_kv, rope_theta=rope)
    with torch.inference_mode():
        got = model(torch.as_tensor(tokens).long(),
                    compute_dtype=_DT[compute][1])
    assert got.dtype == torch.float32 and got.shape == (2, T, VOCAB)
    all_f32 = compute == "float32" and param_dtype == "float32"
    tol = 1e-4 if all_f32 else 3e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_bridge_is_bit_exact_for_bf16():
    p = _jax_params(2, "swiglu", False, "bfloat16")
    tree = tree_from_numpy(_np_tree(p), "cpu")
    w = tree["layer1"]["w3"]
    assert w.dtype == torch.bfloat16
    want = np.asarray(p["layer1"]["w3"]).view(np.int16)
    assert np.array_equal(w.view(torch.int16).numpy(), want)


def test_collect_kv_matches_tpulab():
    from tpulab.models.transformer import transformer_forward_collect_kv
    p = _jax_params(2, "swiglu", False, "float32")
    tokens = np.random.default_rng(2).integers(0, VOCAB, (1, T), np.int32)
    _, kvs = transformer_forward_collect_kv(
        p, jnp.asarray(tokens), n_heads=N_HEADS, n_layers=N_LAYERS,
        compute_dtype=jnp.float32, n_kv_heads=2, rope_theta=500000.0)
    model = params_from_numpy(_np_tree(p), "cpu", n_heads=N_HEADS,
                              n_kv_heads=2)
    _, got = tt.transformer_forward_collect_kv(
        model.params, torch.as_tensor(tokens).long(), n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=torch.float32, n_kv_heads=2,
        rope_theta=500000.0)
    for (kj, vj), (k, v) in zip(kvs, got):
        assert k.shape == (1, T, 2, D_MODEL // N_HEADS)
        np.testing.assert_allclose(k.numpy(), np.asarray(kj), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("last", [0, T - 1, "tensor"])
def test_collect_kv_last_index_matches_tpulab_row(last):
    """``last_index`` runs the vocab head on one position: its logits
    equal that row of tpulab's full (B, T, vocab) logits."""
    from tpulab.models.transformer import transformer_forward_collect_kv
    p = _jax_params(2, "swiglu", False, "float32")
    tokens = np.random.default_rng(4).integers(0, VOCAB, (1, T), np.int32)
    want, _ = transformer_forward_collect_kv(
        p, jnp.asarray(tokens), n_heads=N_HEADS, n_layers=N_LAYERS,
        compute_dtype=jnp.float32, n_kv_heads=2, rope_theta=10000.0)
    idx = torch.tensor(T // 2) if last == "tensor" else last
    model = params_from_numpy(_np_tree(p), "cpu", n_heads=N_HEADS,
                              n_kv_heads=2)
    got, _ = tt.transformer_forward_collect_kv(
        model.params, torch.as_tensor(tokens).long(), n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=torch.float32, n_kv_heads=2,
        rope_theta=10000.0, last_index=idx)
    assert got.shape == (1, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, int(idx)],
                               rtol=1e-4, atol=1e-4)


def test_init_params_shapes_and_seed():
    a = tt.init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                   seed=5, n_kv_heads=2, ffn="swiglu",
                                   tie_embeddings=False, device="cpu")
    b = tt.init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                   seed=5, n_kv_heads=2, ffn="swiglu",
                                   tie_embeddings=False, device="cpu")
    hd = D_MODEL // N_HEADS
    assert a["layer0"]["wqkv"].shape == (D_MODEL, (N_HEADS + 4) * hd)
    assert a["layer1"]["w3"].shape == (D_MODEL, D_FF)
    assert a["lm_head"].shape == (D_MODEL, VOCAB)
    assert torch.equal(a["embed"], b["embed"])
    assert 0.015 < float(a["embed"].std()) < 0.025


def test_int8_weights_are_not_ported():
    """int8 entries are ported now: ``qmat`` dequantizes them (the
    bit-level check against tpulab is in tests/test_torch_quantization.py)
    and ``weight_shape`` reads their shape."""
    w = {"w_int8": torch.tensor([[1, -127], [0, 5]], dtype=torch.int8),
         "scale": torch.tensor([0.5, 2.0])}
    got = tt.qmat(w, torch.float32)
    assert torch.equal(got, torch.tensor([[0.5, -254.0], [0.0, 10.0]]))
    assert tt.weight_shape(w) == (2, 2)


def test_no_cuda_means_no_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.init_transformer_params(VOCAB, D_MODEL, N_HEADS, 1, D_FF)
