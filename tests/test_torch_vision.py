"""The port's image models held against tpulab's apply functions on the
CPU, on the same weights (numpy trees from a seed, bridged with
``tree_from_numpy``) and the same inputs.  tpulab's functions run under
``jax.jit``, once per shape.

Tolerances, on the max abs logit difference against tpulab's:
- f32 compute: ``F32_TOL`` x max(1, max |tpulab logit|) — both backends
  read the same values and sum in f32, only the order differs (about
  1e-6 relative measured);
- bf16 compute on uint8 input: ``BF16_TOL`` x max |tpulab logit|, and the
  same top-1 wherever tpulab's top-1 margin exceeds that tolerance.  XLA
  may keep f32 between fused bf16 ops where eager PyTorch rounds after
  each; tpulab's own bf16 logits sit about 1.4e-2 (relative) from its f32
  ones at these shapes.

Covered: ResNet-50 at image 32, 10 classes, batch 2 (float at f32,
uint8 at bf16; its 7x7/2 stem pads (2, 3) and its 3x3/2 convs (0, 1),
which symmetric padding would shift), ResNet-101 at f32, JAX's SAME padding and the max pool
against ``lax`` directly, the uint8 normalization bit for bit, ViT-S/16
at image 32 in both dialects, MNIST, the placed trees and the weight
bridge.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.models import mnist as jm
from tpulab.models import resnet as jr
from tpulab.models import vit as jv
from tpulab_torch.models import mnist as tm
from tpulab_torch.models import resnet as tr
from tpulab_torch.models import vit as tv
from tpulab_torch.models.convert import tree_from_numpy

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_TOL = 3e-2
IMG, CLASSES, BATCH = 32, 10, 2


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _check(label, got, want, tol, margin_rule=False):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    bound = tol * (scale if margin_rule else max(1.0, scale))
    assert np.isfinite(got).all() and err <= bound, (label, err, bound)
    if margin_rule:
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > bound
        assert (got.argmax(-1) == want.argmax(-1))[clear].all(), label


# ---------------------------------------------------------------- ResNet
def _np_resnet(depth=50, classes=CLASSES, seed=0):
    """tpulab's tree layout with He-init kernels and non-trivial folded
    BN (scale in [0.3, 0.8], bias N(0, 0.1)) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def unit(kh, kw, cin, cout):
        return {"kernel": (rng.standard_normal((kh, kw, cin, cout))
                           * np.sqrt(2 / (kh * kw * cin))).astype(np.float32),
                "scale": rng.uniform(0.3, 0.8, (cout,)).astype(np.float32),
                "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}

    p = {"stem": unit(7, 7, 3, 64)}
    cin = 64
    for stage, blocks in enumerate(jr.STAGE_SIZES[depth]):
        cmid = 64 * 2 ** stage
        cout = cmid * 4
        for b in range(blocks):
            u = {"conv1": unit(1, 1, cin, cmid),
                 "conv2": unit(3, 3, cmid, cmid),
                 "conv3": unit(1, 1, cmid, cout)}
            if (b == 0 and stage > 0) or cin != cout:
                u["proj"] = unit(1, 1, cin, cout)
            p[f"s{stage}b{b}"] = u
            cin = cout
    p["fc"] = {"kernel": (rng.standard_normal((cin, classes)) * 0.05
                          ).astype(np.float32),
               "bias": (rng.standard_normal(classes) * 0.1
                        ).astype(np.float32)}
    return p


@pytest.fixture(scope="module")
def resnet():
    p = _np_resnet()
    return p, _jax_tree(p), tree_from_numpy(p, "cpu")


def _jax_resnet(jp, x, dtype, depth=50):
    fn = jax.jit(lambda p, i: jr.resnet_apply(p, i, depth, dtype))
    return np.asarray(fn(jp, {"input": x})["logits"])


def test_resnet50_float_input_f32_matches_tpulab(resnet):
    _, jp, tp = resnet
    x = np.random.default_rng(1).standard_normal(
        (BATCH, IMG, IMG, 3)).astype(np.float32)
    want = _jax_resnet(jp, x, jnp.float32)
    got = tr.resnet_apply(tp, {"input": torch.from_numpy(x)}, 50,
                          torch.float32)["logits"]
    assert got.dtype == torch.float32 and got.shape == (BATCH, CLASSES)
    _check("resnet50 f32", got.numpy(), want, F32_TOL)


def test_resnet101_float_input_f32_matches_tpulab():
    """The deeper stage plan (3, 4, 23, 3) at batch 1."""
    p = _np_resnet(depth=101, seed=9)
    x = np.random.default_rng(10).standard_normal(
        (1, IMG, IMG, 3)).astype(np.float32)
    want = _jax_resnet(_jax_tree(p), x, jnp.float32, depth=101)
    got = tr.resnet_apply(tree_from_numpy(p, "cpu"),
                          {"input": torch.from_numpy(x)}, 101,
                          torch.float32)["logits"]
    _check("resnet101 f32", got.numpy(), want, F32_TOL)


def test_resnet50_uint8_input_bf16_matches_tpulab(resnet):
    _, jp, tp = resnet
    x = np.random.default_rng(2).integers(
        0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8)
    want = _jax_resnet(jp, x, jnp.bfloat16)
    got = tr.resnet_apply(tp, {"input": torch.from_numpy(x)}, 50,
                          torch.bfloat16)["logits"]
    _check("resnet50 uint8 bf16", got.numpy(), want, BF16_TOL,
           margin_rule=True)
    # the placed tree (OIHW bf16 kernels made once) computes the same bits
    placed = tr.place_resnet_params(tp, "cpu", torch.bfloat16)
    again = tr.resnet_apply(placed, {"input": torch.from_numpy(x)}, 50,
                            torch.bfloat16)["logits"]
    assert torch.equal(got, again)
    assert placed["stem"]["w"].shape == (64, 3, 7, 7)
    assert placed["stem"]["w"].is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (32, 7, 2, (2, 3)), (56, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
    (28, 5, 1, (2, 2))])
def test_same_pads_are_jax_same(size, k, stride, pads):
    assert tr.same_pads(size, k, stride) == pads
    rng = np.random.default_rng(size + k + stride)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = tr.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                       tr.oihw(torch.from_numpy(w), torch.float32), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_max_pool_matches_reduce_window():
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 16, 5)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)]))
    got = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("mean,std", [(None, None), (0.5, 0.5)])
def test_uint8_normalization_is_bit_equal(mean, std):
    """Every pixel value through ``(c(x) - c(mean)*255) / (c(std)*255)``,
    op by op in bf16 as JAX rounds it (eager, no fusion)."""
    x = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 3))
    jmean = (jnp.asarray(jr.IMAGENET_MEAN, jnp.bfloat16) if mean is None
             else jnp.full((3,), mean, jnp.float32).astype(jnp.bfloat16))
    jstd = (jnp.asarray(jr.IMAGENET_STD, jnp.bfloat16) if std is None
            else jnp.full((3,), std, jnp.float32).astype(jnp.bfloat16))
    want = (jnp.asarray(x).astype(jnp.bfloat16) - jmean * 255.0) \
        / (jstd * 255.0)
    stats = tr.norm_stats(
        "cpu", torch.bfloat16,
        None if mean is None else torch.full((3,), mean),
        None if std is None else torch.full((3,), std))
    got = tr.normalize_uint8(torch.from_numpy(x), torch.bfloat16, stats)
    np.testing.assert_array_equal(
        _bits(got), np.asarray(want).view(np.int16))


@pytest.mark.parametrize("depth,n_params", [
    (50, 25_557_032), (101, 44_549_160), (152, 60_192_808)])
def test_resnet_depths_have_the_published_parameter_counts(depth, n_params):
    """Kernels, folded-BN scale/bias and the head: torchvision's counts."""
    tree = tr.init_resnet_params(depth, 1000, seed=0, device="cpu")
    model = tr.make_resnet(depth, params=tree)
    assert model.weights_size_in_bytes() == 4 * n_params
    assert tree["stem"]["kernel"].shape == (7, 7, 3, 64)
    assert tree["fc"]["kernel"].shape == (2048, 1000)


# ------------------------------------------------------------------- ViT
VIT_S = dict(d=384, heads=6, layers=12, ff=1536, patch=16)


def _np_vit(classic: bool, seed=4):
    rng = np.random.default_rng(seed)
    d, ff, c = VIT_S["d"], VIT_S["ff"], VIT_S["patch"]

    def nrm(*shape, s=0.02):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm():
        n = {"scale": 1 + nrm(d, s=0.1)}
        if classic:
            n["bias"] = nrm(d, s=0.1)
        return n

    p = {"patch_embed": nrm(c * c * 3, d), "cls": nrm(d),
         "pos_embed": nrm((IMG // c) ** 2 + 1, d), "final_norm": norm(),
         "head": {"kernel": nrm(d, CLASSES), "bias": nrm(CLASSES)}}
    for i in range(VIT_S["layers"]):
        p[f"layer{i}"] = {"ln1": norm(), "ln2": norm(),
                          "wqkv": nrm(d, 3 * d), "wo": nrm(d, d),
                          "w1": nrm(d, ff), "w2": nrm(ff, d)}
    if classic:      # an HF-style import: biases, its eps, its processor
        p["patch_bias"] = nrm(d)
        p["norm_mean"] = np.full((3,), 0.5, np.float32)
        p["norm_std"] = np.full((3,), 0.5, np.float32)
        for i in range(VIT_S["layers"]):
            lp = p[f"layer{i}"]
            lp["ln1"]["eps"] = lp["ln2"]["eps"] = 1e-12
            lp.update(bqkv=nrm(3 * d), bo=nrm(d), b1=nrm(ff), b2=nrm(d))
    return p


@pytest.mark.parametrize("classic", [False, True],
                         ids=["rmsnorm_tanh", "layernorm_erf"])
@pytest.mark.parametrize("kind", ["float_f32", "uint8_bf16"])
def test_vit_s16_matches_tpulab(classic, kind):
    p = _np_vit(classic)
    rng = np.random.default_rng(5)
    if kind == "float_f32":
        x = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
        jdt, tdt = jnp.float32, torch.float32
    else:
        x = rng.integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8)
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    kw = dict(n_heads=VIT_S["heads"], n_layers=VIT_S["layers"],
              patch_size=VIT_S["patch"])
    fn = jax.jit(lambda q, i: jv.vit_apply(q, i, compute_dtype=jdt, **kw))
    want = np.asarray(fn(_jax_tree(p), {"input": x})["logits"])
    tp = tree_from_numpy(p, "cpu")
    got = tv.vit_apply(tp, {"input": torch.from_numpy(x)},
                       compute_dtype=tdt, **kw)["logits"]
    assert got.dtype == torch.float32
    if kind == "float_f32":
        _check(f"vit {classic} f32", got.numpy(), want, F32_TOL)
    else:
        _check(f"vit {classic} bf16", got.numpy(), want, BF16_TOL,
               margin_rule=True)
    placed = tv.place_vit_params(tp, "cpu", tdt)
    assert placed["head"]["kernel"].dtype == torch.float32
    assert placed["layer0"]["wqkv"].dtype == tdt
    if classic:
        assert placed["layer0"]["ln1"]["eps"] == 1e-12
    again = tv.vit_apply(placed, {"input": torch.from_numpy(x)},
                         compute_dtype=tdt, **kw)["logits"]
    assert torch.equal(got, again)


def test_vit_patchify_order_matches_patch_embed_rows():
    """tpulab's (B, Hp, p, Wp, p, C) -> (B, N, p*p*C) order, element for
    element (row (i * p + j) * C + c of a patch is its pixel (i, j, c))."""
    x = np.arange(2 * IMG * IMG * 3, dtype=np.float32).reshape(
        2, IMG, IMG, 3)
    p = VIT_S["patch"]
    want = x.reshape(2, IMG // p, p, IMG // p, p, 3).transpose(
        0, 1, 3, 2, 4, 5).reshape(2, (IMG // p) ** 2, p * p * 3)
    got = tv.patchify(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 2, (3 * p + 5) * 3 + 2] == x[0, p + 3, 5, 2]


# ----------------------------------------------------------------- MNIST
def test_mnist_matches_tpulab():
    m = jm.make_mnist(max_batch_size=4, seed=3)
    tree = jax.tree_util.tree_map(np.asarray, m.params)
    x = np.random.default_rng(6).standard_normal(
        (3, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.mnist_apply)(
        m.params, {"Input3": x})["Plus214_Output_0"])
    tp = tree_from_numpy(tree, "cpu")
    got = tm.mnist_apply(tp, {"Input3": torch.from_numpy(x)})
    _check("mnist", got["Plus214_Output_0"].numpy(), want, F32_TOL)
    placed = tm.place_mnist_params(tp, "cpu")
    again = tm.mnist_apply(placed, {"Input3": torch.from_numpy(x)})
    assert torch.equal(got["Plus214_Output_0"], again["Plus214_Output_0"])


def test_bridge_keeps_leaves_and_passes_scalars():
    p = _np_vit(True)
    tp = tree_from_numpy(p, "cpu", dtype=torch.bfloat16)
    assert tp["layer0"]["ln1"]["eps"] == 1e-12           # a python scalar
    assert tp["patch_embed"].dtype == torch.bfloat16
    assert tp["patch_embed"].shape == p["patch_embed"].shape
    f = tree_from_numpy(copy.deepcopy(p), "cpu")
    np.testing.assert_array_equal(f["layer3"]["w1"].numpy(),
                                  p["layer3"]["w1"])
