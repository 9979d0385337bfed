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


# -- ResNet: W8 / W8A8, calibration and the registry ---------------------------
# Tolerances: int8 values, scales and W8A8 int32 accumulators bit for bit;
# ResNet-50 logits at f32 within RN_TOL (tpulab's own ResNet-50 depth
# tolerance: the two backends sum in different orders, 53 convs deep);
# calibrated ranges within 1e-4 relative (f32 absmax of the same forward).
RN_TOL = 2e-3
RN_IMG = 32


@pytest.fixture(scope="module")
def rn():
    """tpulab's f32 ResNet-50, its ranges over two seeded batches and its
    jitted f32 forward; the same tree on the port."""
    from functools import partial
    from types import SimpleNamespace

    from tpulab.models import resnet as jr

    pj = jr.init_resnet_params(50, seed=0)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((1, RN_IMG, RN_IMG, 3)).astype(
        np.float32) for _ in range(2)]
    return SimpleNamespace(
        pj=pj, pt=tree_from_numpy(_np(pj), "cpu"), batches=batches,
        ranges=jq.calibrate_resnet(pj, batches),
        x=rng.standard_normal((2, RN_IMG, RN_IMG, 3)).astype(np.float32),
        apply=jax.jit(partial(jr.resnet_apply, compute_dtype=jnp.float32)))


def _rn_logits(params, x):
    from tpulab_torch.models.resnet import resnet_apply
    with torch.inference_mode():
        return resnet_apply(params, {"input": torch.from_numpy(x)},
                            compute_dtype=torch.float32)["logits"].numpy()


def _units(tree, prefix=""):
    """(name, unit) of every conv unit, tpulab's names."""
    if "kernel" in tree and "scale" in tree:
        yield prefix.lstrip("/"), tree
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _units(v, f"{prefix}/{k}")


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_resnet_quantize_is_bit_equal_to_tpulab(rn, mode):
    from tpulab_torch.models.quantization import (quantize_resnet_params,
                                                  quantize_resnet_params_w8a8,
                                                  quantized_bytes)
    if mode == "w8":
        want, got = (jq.quantize_resnet_params(rn.pj),
                     quantize_resnet_params(rn.pt))
    else:
        want = jq.quantize_resnet_params_w8a8(rn.pj, rn.ranges)
        got = quantize_resnet_params_w8a8(rn.pt, rn.ranges)
    units = dict(_units(got))
    assert len(units) == 53 and set(units) == {n for n, _ in _units(want)}
    for name, u in _units(want):
        assert units[name]["kernel"].dtype == torch.int8
        assert ("act_scale" in units[name]) == (mode == "w8a8")
    _same_tree(_np(want), got)
    assert quantized_bytes(got) == jq.quantized_bytes(want)
    assert quantized_bytes(got) < 0.35 * quantized_bytes(rn.pt)


def test_resnet_quantize_edge_channels():
    """An all-zero output channel takes scale 1, exact ties round half to
    even: bit-equal to tpulab on a planted kernel."""
    from tpulab_torch.models.quantization import _quantize_kernel
    k = np.random.default_rng(2).standard_normal((3, 3, 16, 8)).astype(
        np.float32)
    k[..., 3] = 0.0
    k[..., 4] = (np.arange(144).reshape(3, 3, 16) - 72).astype(np.float32)
    k[0, 0, 0, 4] = 127.0                  # absmax 127: scale exactly 1
    want = jq._quantize_kernel(k)
    got = _quantize_kernel(torch.from_numpy(k))
    assert np.array_equal(got["kernel"].numpy(), np.asarray(want["kernel"]))
    assert np.array_equal(_bits(got["kernel_scale"]),
                          _bits(want["kernel_scale"]))
    assert float(got["kernel_scale"][3]) == 1.0


def test_resnet_w8_logits_match_tpulab(rn):
    """Weight-only int8 (dequantized in each forward, tpulab's rounding)
    on the raw and on the placed tree (the int8 kernel stays resident):
    tpulab's logits within RN_TOL, and tpulab's accuracy bounds against
    the f32 model."""
    from tpulab_torch.models.quantization import quantize_resnet_params
    from tpulab_torch.models.resnet import place_resnet_params

    qt = quantize_resnet_params(rn.pt)
    got = _rn_logits(qt, rn.x)
    want = np.asarray(rn.apply(jq.quantize_resnet_params(rn.pj),
                               {"input": rn.x})["logits"])
    np.testing.assert_allclose(got, want, rtol=RN_TOL, atol=RN_TOL)
    placed = place_resnet_params(qt, "cpu", torch.float32)
    assert placed["stem"]["kernel"].dtype == torch.int8
    assert "w" not in placed["stem"]
    assert np.array_equal(_rn_logits(placed, rn.x), got)
    full = _rn_logits(rn.pt, rn.x)
    assert np.abs(full - got).max() / np.abs(full).max() < 0.1
    assert np.corrcoef(full.ravel(), got.ravel())[0, 1] > 0.99


def test_resnet_w8a8_logits_match_tpulab(rn):
    """W8A8 on tpulab's ranges: act_scale bit for bit, logits within
    RN_TOL of tpulab's, the placed tree (int8 kernels resident) bit-equal
    to the raw one, and tpulab's accuracy bound against f32."""
    from tpulab_torch.models.quantization import quantize_resnet_params_w8a8
    from tpulab_torch.models.resnet import place_resnet_params

    qt = quantize_resnet_params_w8a8(rn.pt, rn.ranges)
    got = _rn_logits(qt, rn.x)
    want = np.asarray(rn.apply(jq.quantize_resnet_params_w8a8(
        rn.pj, rn.ranges), {"input": rn.x})["logits"])
    np.testing.assert_allclose(got, want, rtol=RN_TOL, atol=RN_TOL)
    placed = place_resnet_params(qt, "cpu", torch.float32)
    assert placed["s1b0"]["conv2"]["kernel"].shape == (3, 3, 128, 128)
    assert placed["s1b0"]["conv2"]["act_scale"].dtype == torch.float32
    assert np.array_equal(_rn_logits(placed, rn.x), got)
    full = _rn_logits(rn.pt, rn.x)
    assert np.corrcoef(full.ravel(), got.ravel())[0, 1] > 0.95


def test_calibrate_resnet_matches_tpulab(rn):
    from tpulab_torch.models.quantization import calibrate_resnet
    got = calibrate_resnet(rn.pt, rn.batches)
    assert set(got) == set(rn.ranges) and len(got) == 53
    assert "stem" in got and "s0b0/conv1" in got
    for k, v in rn.ranges.items():
        assert got[k] > 0
        assert abs(got[k] - v) <= 1e-4 * v, k


@pytest.mark.parametrize("cin,cout,k,stride,size", [
    (3, 64, 7, 2, 19),          # the stem: K = 147, padded to 152 on CUDA
    (16, 24, 3, 2, 9),
    (16, 8, 3, 1, 8),
    (32, 16, 1, 2, 7),
    (24, 16, 1, 1, 5),
], ids=["stem7x7s2", "3x3s2", "3x3s1", "1x1s2", "1x1s1"])
def test_int8_conv_accumulators_are_bit_equal(cin, cout, k, stride, size):
    """One W8A8 conv's int32 accumulators (quantized activation, SAME
    padding, exact integer products) against JAX's int8 convolution with
    ``preferred_element_type=int32``, bit for bit."""
    from tpulab_torch.models.resnet import int8_conv, quantize_activation

    rng = np.random.default_rng(cin * 100 + k)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32) * 3
    act_scale = np.float32(0.021)
    xq_j = jnp.clip(jnp.round(x / act_scale), -127, 127).astype(jnp.int8)
    xq_t = quantize_activation(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.tensor(act_scale))
    assert np.array_equal(xq_t.permute(0, 2, 3, 1).numpy(),
                          np.asarray(xq_j))
    kernel = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        xq_j, kernel, window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = int8_conv(xq_t, torch.from_numpy(kernel).permute(3, 0, 1, 2),
                    stride)
    assert got.dtype == torch.int32
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_w8a8_out_of_range_input_clips_not_explodes(rn):
    from tpulab_torch.models.quantization import (calibrate_resnet,
                                                  quantize_resnet_params_w8a8)
    small = [np.full((1, RN_IMG, RN_IMG, 3), 0.1, np.float32)]
    q = quantize_resnet_params_w8a8(rn.pt, calibrate_resnet(rn.pt, small))
    out = _rn_logits(q, np.full((1, RN_IMG, RN_IMG, 3), 50.0, np.float32))
    assert np.isfinite(out).all()


def test_calibrator_ranges_and_cache(tmp_path, rn):
    """The port's Calibrator over the f32 ResNet: input absmax exact, the
    output range tpulab's within 1e-4; the cache file is byte for byte
    what tpulab's save writes for the same ranges, and each package loads
    the other's."""
    from functools import partial

    from tpulab.models import resnet as jr
    from tpulab_torch.models.quantization import Calibrator
    from tpulab_torch.models.resnet import resnet_apply

    batches = [{"input": np.full((1, RN_IMG, RN_IMG, 3), v, np.float32)}
               for v in (0.5, -2.0, 1.0)]
    cal = Calibrator(partial(resnet_apply, compute_dtype=torch.float32),
                     rn.pt)
    ranges = cal.run(batches)
    jcal = jq.Calibrator(partial(jr.resnet_apply,
                                 compute_dtype=jnp.float32), rn.pj)
    want = jcal.run(batches)
    assert set(ranges) == set(want) == {"input:input", "output:logits"}
    assert ranges["input:input"] == want["input:input"] == 2.0
    assert abs(ranges["output:logits"] - want["output:logits"]) <= \
        1e-4 * want["output:logits"]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    cal.save(str(ours))
    jcal.ranges = dict(ranges)
    jcal.save(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert Calibrator.load(str(ours)) == ranges == jq.Calibrator.load(
        str(ours))


def test_resnet50_int8_registry_entry(rn):
    """``build_model("resnet50_int8")``: tpulab's names, int8 kernels
    resident (the weights' bytes count int8), the f32 head; its forward
    on tpulab's quantized tree is tpulab's within RN_TOL, served through
    the port's Runtime (placed tree) bit-equal to the direct forward."""
    from tpulab.models import build_model as jax_build
    from tpulab_torch.engine.runtime import Runtime
    from tpulab_torch.models import build_model
    from tpulab_torch.models.quantization import quantized_bytes

    kw = dict(image_size=RN_IMG, max_batch_size=2)
    jm = jax_build("resnet50_int8", compute_dtype=jnp.float32, **kw)
    pm = build_model("resnet50_int8", compute_dtype=torch.float32,
                     device="cpu", **kw)
    assert pm.name == jm.name == "resnet50_int8"
    assert pm.batch_buckets == jm.batch_buckets
    assert pm.params["stem"]["kernel"].dtype == torch.int8
    assert pm.params["stem"]["kernel_scale"].shape == (64,)
    assert pm.params["fc"]["kernel"].dtype == torch.float32
    assert pm.weights_size_in_bytes() == quantized_bytes(pm.params)
    assert pm.weights_size_in_bytes() == jq.quantized_bytes(jm.params)
    tree = tree_from_numpy(_np(jm.params), "cpu")
    got = _rn_logits(tree, rn.x)
    want = np.asarray(rn.apply(jm.params, {"input": rn.x})["logits"])
    np.testing.assert_allclose(got, want, rtol=RN_TOL, atol=RN_TOL)
    pm.params = tree
    compiled = Runtime("cpu").compile_model(pm)
    out = compiled(2, {"input": torch.from_numpy(rn.x)})["logits"]
    assert np.array_equal(out.numpy(), got)
