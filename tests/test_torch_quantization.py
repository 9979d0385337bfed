"""Weight-only int8 (W8A16) transformers on the port, held against tpulab
on the CPU.

- ``quantize_transformer_params`` gives tpulab's ``w_int8`` and
  ``scale`` bit for bit from f32 and from bf16 weights, the untied
  ``lm_head`` included; ``transformer_param_bytes`` agrees.
- ``qmat`` is bit-equal to tpulab's at bf16 and f32 compute.
- ``transformer_apply`` logits on an int8 tree agree with tpulab's within
  1e-4 (f32; the tolerance of tests/test_torch_transformer.py: the two
  backends sum in different orders).
- The weight bridge carries int8 leaves bit-exact, and ``dtype=`` recasts
  floating leaves only.
- The batcher on int8 params gives the dense ``make_generate_fn``'s
  stream exactly (tpulab's own oracle) and tpulab's batcher's stream,
  under both plans, and with speculation (the early-exit draft shares
  the quantized tensors) the stream of plain blocks; the dense
  ``SpeculativeGenerator`` equals ``make_generate_fn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.models import quantization as jq
from tpulab.models import transformer as jt
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.engine.speculative import SpeculativeGenerator
from tpulab_torch.models import transformer as tt
from tpulab_torch.models.convert import params_from_numpy, tree_from_numpy
from tpulab_torch.models.quantization import (quantize_matrix,
                                              quantize_transformer_params,
                                              transformer_param_bytes)

torch.set_num_threads(2)

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS, D_FF = 64, 64, 4, 2, 2, 128
ROPE = 10000.0
KW = dict(n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV,
          rope_theta=ROPE)
CFG = dict(KW, lanes=2, max_len=48, page_size=8, prefix_cache=True)
PLANS = {"ragged": dict(ragged=True), "split": dict(ragged=False)}
JAX_PLANS = {"ragged": dict(use_kernel=False, ragged=True),
             "split": dict(use_kernel=False)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x) -> np.ndarray:
    """The bit pattern of a tensor or array of any 1-, 2- or 4-byte type."""
    if isinstance(x, torch.Tensor):
        x = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


@pytest.fixture(scope="module")
def lm():
    """tpulab's params (GQA, RoPE, SwiGLU, untied lm_head) and both
    packages' int8 trees of them."""
    pj = jt.init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                    seed=3, n_kv_heads=N_KV, ffn="swiglu",
                                    tie_embeddings=False)
    qj = jq.quantize_transformer_params(pj)
    model = params_from_numpy(_np(pj), "cpu", **{
        k: KW[k] for k in ("n_heads", "n_kv_heads", "rope_theta")})
    return pj, qj, model, quantize_transformer_params(model)


def _same_tree(want, got):
    assert set(want) == set(got)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_tree(w, got[k])
        else:
            assert str(got[k].dtype).split(".")[-1] == np.asarray(
                w).dtype.name, k
            assert np.array_equal(_bits(got[k]), _bits(w)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_equal_to_tpulab(dtype):
    pj = jt.init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                    seed=4, n_kv_heads=N_KV, ffn="swiglu",
                                    tie_embeddings=False)
    pj = jax.tree_util.tree_map(lambda x: x.astype(dtype), pj)
    want = _np(jq.quantize_transformer_params(pj))
    got = quantize_transformer_params(tree_from_numpy(_np(pj), "cpu"))
    for name in ("layer0", "layer1"):
        for k in ("wqkv", "wo", "w1", "w2", "w3"):
            assert got[name][k]["w_int8"].dtype == torch.int8
            assert got[name][k]["scale"].dtype == torch.float32
    assert "w_int8" in got["lm_head"]
    _same_tree(want, got)
    assert transformer_param_bytes(got) == jq.transformer_param_bytes(
        jq.quantize_transformer_params(pj))


def test_quantize_edge_columns():
    """An all-zero column takes scale 1, ties round half to even, and
    the clip holds: bit-equal to tpulab on a seeded 256 x 384 matrix with
    such columns planted."""
    w = np.random.default_rng(0).standard_normal((256, 384)).astype(
        np.float32)
    w[:, 5] = 0.0
    w[:, 6] = np.linspace(-127, 127, 256).astype(np.float32) * 0.5
    want = jq._quantize_matrix(w)
    got = quantize_matrix(torch.from_numpy(w))
    assert np.array_equal(got["w_int8"].numpy(), np.asarray(want["w_int8"]))
    assert np.array_equal(_bits(got["scale"]), _bits(want["scale"]))
    assert float(got["scale"][5]) == 1.0


def test_quantize_keeps_lm_head_float_when_asked(lm):
    _, _, model, _ = lm
    tree = quantize_transformer_params(model, quantize_lm_head=False)
    assert tree["lm_head"] is model.params["lm_head"]
    assert tree["embed"] is model.params["embed"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmat_is_bit_equal_to_tpulab(lm, dtype):
    _, qj, _, qt = lm
    for name, key in (("layer0", "wqkv"), ("layer1", "w2"),
                      ("lm_head", None)):
        wj = qj[name] if key is None else qj[name][key]
        wt = qt[name] if key is None else qt[name][key]
        want = jt.qmat(wj, getattr(jnp, dtype))
        got = tt.qmat(wt, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(_bits(got), _bits(want)), (name, key)
        assert tt.weight_shape(wt) == jt.weight_shape(wj)


def test_logits_on_int8_tree_match_tpulab(lm):
    _, qj, _, qt = lm
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 16), np.int32)
    want = jt.transformer_apply(qj, {"tokens": jnp.asarray(tokens)},
                                compute_dtype=jnp.float32, **KW)["logits"]
    got = tt.transformer_apply(qt, {"tokens": torch.from_numpy(tokens)},
                               compute_dtype=torch.float32, **KW)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_module_holds_int8_entries(lm):
    """A Transformer over an int8 tree holds each entry as frozen
    parameters and gives the tree back; the early-exit draft shares its
    tensors."""
    _, _, _, qt = lm
    module = tt.Transformer(qt, n_heads=N_HEADS, n_kv_heads=N_KV,
                            rope_theta=ROPE)
    tree = module.params
    w = tree["layer1"]["w3"]
    assert isinstance(w, dict) and w["w_int8"].dtype == torch.int8
    assert w["w_int8"].data_ptr() == qt["layer1"]["w3"]["w_int8"].data_ptr()
    assert not any(p.requires_grad for p in module.parameters())
    assert transformer_param_bytes(module) == transformer_param_bytes(qt)
    draft = tt.early_exit_draft(module, 1)
    assert draft["lm_head"]["w_int8"].data_ptr() == \
        qt["lm_head"]["w_int8"].data_ptr()


def test_bridge_carries_int8_leaves(lm):
    """tpulab's quantized tree over the bridge with dtype=bf16: int8
    payloads pass untouched and bit-equal; float leaves (scales included,
    as tpulab's own bf16 cast of a quantized tree does) become bf16."""
    _, qj, _, _ = lm
    tree = tree_from_numpy(_np(qj), "cpu", dtype=torch.bfloat16)
    w = tree["layer0"]["wqkv"]
    assert w["w_int8"].dtype == torch.int8
    assert np.array_equal(w["w_int8"].numpy(),
                          np.asarray(qj["layer0"]["wqkv"]["w_int8"]))
    assert w["scale"].dtype == torch.bfloat16
    assert tree["embed"].dtype == torch.bfloat16
    model = params_from_numpy(_np(qj), "cpu", n_heads=N_HEADS,
                              n_kv_heads=N_KV, rope_theta=ROPE)
    assert np.array_equal(
        model.params["lm_head"]["w_int8"].numpy(),
        np.asarray(qj["lm_head"]["w_int8"]))


# -- serving on int8 trees ------------------------------------------------------
def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, VOCAB, (n,), np.int32) for n in (12, 5, 20)]


def _serve(cb):
    return [list(cb.submit(p, 6).result(timeout=300)) for p in _prompts()]


@pytest.fixture(scope="module")
def dense(lm):
    _, _, _, qt = lm
    gen = tt.make_generate_fn(qt, max_len=48, compute_dtype=torch.float32,
                              **KW)
    return [gen(p[None], 6)[0].tolist() for p in _prompts()]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_int8_batcher_matches_dense_and_tpulab(lm, dense, plan):
    """Exact against the dense generator on the same int8 tree (tpulab's
    own oracle, tests/test_quantization.py) and against tpulab's batcher
    on its int8 tree."""
    _, qj, _, qt = lm
    ref = JaxBatcher(qj, compute_dtype=jnp.float32, **CFG, **JAX_PLANS[plan])
    try:
        want = _serve(ref)
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(qt, compute_dtype=torch.float32, device="cpu",
                           **CFG, **PLANS[plan])
    try:
        got = _serve(cb)
    finally:
        cb.shutdown()
    assert got == dense
    assert got == [[int(t) for t in s] for s in want]


@pytest.mark.parametrize("kv_dtype", [None, torch.float8_e4m3fn])
def test_int8_speculative_equals_plain_blocks(lm, kv_dtype):
    """The early-exit draft of an int8 tree (sharing its quantized
    tensors) over an f32 or e4m3 pool: the stream of plain blocks."""
    _, _, _, qt = lm
    streams = {}
    for mode in ("plain", "spec"):
        extra = (dict(draft_params=tt.early_exit_draft(qt, 1),
                      draft_n_layers=1) if mode == "spec" else {})
        cb = ContinuousBatcher(qt, compute_dtype=torch.float32,
                               device="cpu", kv_dtype=kv_dtype, **CFG,
                               **extra)
        try:
            streams[mode] = _serve(cb)
            if mode == "spec":
                assert cb.spec_dispatches > 0
        finally:
            cb.shutdown()
    assert streams["spec"] == streams["plain"]


def test_int8_dense_speculative_generator(lm, dense):
    _, _, _, qt = lm
    gen = SpeculativeGenerator(qt, tt.early_exit_draft(qt, 1),
                               draft_n_layers=1, k=3, max_len=48,
                               compute_dtype=torch.float32, device="cpu",
                               **KW)
    assert [gen.generate(p, 6) for p in _prompts()] == dense
