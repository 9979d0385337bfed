"""The port's PyTorch / Hugging Face weight import held against tpulab's
on the CPU (``tpulab/models/torch_import.py``; tpulab's cases are
``tests/test_serving_extras.py``'s ResNet and Llama imports).

- Each importer's tree equals ``convert.tree_from_numpy`` of tpulab's
  result on the same state dict, bit for bit (f32 leaves, the BN fold in
  f32 numpy, transposes and the q / k / v fusion exact), from f32 numpy,
  f32 tensors, bf16 tensors and a checkpoint file
  (``torch.load(weights_only=True)``).
- The imported ResNet-50 serves tpulab's logits within 2e-3 (ResNet-50
  depth at f32); the imported Llama's batcher streams equal the port's
  dense ``make_generate_fn`` and tpulab's batcher exactly; the imported
  ViT's logits equal tpulab's within 1e-4 (f32).
- Against Hugging Face itself (``transformers``, skipped where it is not
  installed): a tiny ``LlamaForCausalLM`` and ``ViTForImageClassification``
  give the logits the port computes on their imported weights, within
  1e-4 (f32).
"""

import numpy as np
import pytest
import torch

from tpulab.models import torch_import as jti
from tpulab_torch.models import torch_import as tti

torch.set_num_threads(2)

TOL = 1e-4          # f32 blocks and heads
RN_TOL = 2e-3       # ResNet-50 depth at f32


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view({1: np.int8, 2: np.int16, 4: np.int32}[x.itemsize])


def _same_tree(want, got):
    """``got`` (the port's tree) equals ``want`` (tpulab's) leaf for leaf,
    bit for bit, dtypes and shapes included."""
    assert set(want) == set(got)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_tree(w, got[k])
            continue
        g = got[k]
        assert isinstance(g, torch.Tensor), k
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, k
        assert g.dtype == torch.from_numpy(np.empty(0, w.dtype)).dtype, k
        assert g.is_contiguous(), k
        assert np.array_equal(_bits(g), _bits(w)), k


# ------------------------------------------------------------------ ResNet
def _resnet_sd(seed=0, kind="numpy"):
    """A torchvision-layout ResNet-50 state_dict of seeded weights."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(prefix_c, prefix_b, cout, cin, k):
        sd[f"{prefix_c}.weight"] = rng.standard_normal(
            (cout, cin, k, k)).astype(np.float32) * 0.05
        sd[f"{prefix_b}.weight"] = (1 + rng.standard_normal(cout) * 0.1
                                    ).astype(np.float32)
        sd[f"{prefix_b}.bias"] = (rng.standard_normal(cout) * 0.1
                                  ).astype(np.float32)
        sd[f"{prefix_b}.running_mean"] = (rng.standard_normal(cout) * 0.1
                                          ).astype(np.float32)
        sd[f"{prefix_b}.running_var"] = np.abs(
            1 + rng.standard_normal(cout) * 0.1).astype(np.float32)

    add("conv1", "bn1", 64, 3, 7)
    cin = 64
    for stage, blocks in enumerate([3, 4, 6, 3]):
        cmid = 64 * 2 ** stage
        cout = cmid * 4
        for b in range(blocks):
            pre = f"layer{stage + 1}.{b}"
            add(f"{pre}.conv1", f"{pre}.bn1", cmid, cin, 1)
            add(f"{pre}.conv2", f"{pre}.bn2", cmid, cmid, 3)
            add(f"{pre}.conv3", f"{pre}.bn3", cout, cmid, 1)
            if b == 0:
                add(f"{pre}.downsample.0", f"{pre}.downsample.1", cout, cin,
                    1)
            cin = cout
    sd["fc.weight"] = rng.standard_normal((1000, 2048)).astype(
        np.float32) * 0.01
    sd["fc.bias"] = rng.standard_normal(1000).astype(np.float32)
    if kind == "tensor":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_resnet_params_equal_tpulabs(kind):
    sd = _resnet_sd(kind=kind)
    want = jti.resnet_params_from_torch(sd, depth=50)
    got = tti.resnet_params_from_torch(sd, depth=50, device="cpu")
    _same_tree(want, got)
    assert got["stem"]["kernel"].shape == (7, 7, 3, 64)
    assert "proj" in got["s0b0"] and "proj" not in got["s0b1"]
    with pytest.raises(ValueError, match="unsupported depth"):
        tti.resnet_params_from_torch(sd, depth=34, device="cpu")


def test_make_resnet_from_torch_checkpoint_serves_tpulabs_logits(tmp_path):
    """A checkpoint file (tensors, ``torch.load(weights_only=True)``)
    through ``make_resnet_from_torch`` at f32: tpulab's model's logits
    on the same file within RN_TOL."""
    import jax.numpy as jnp

    path = tmp_path / "rn50.pt"
    torch.save(_resnet_sd(seed=1, kind="tensor"), str(path))
    pm = tti.make_resnet_from_torch(str(path), depth=50, image_size=32,
                                    max_batch_size=2,
                                    compute_dtype=torch.float32,
                                    device="cpu")
    jm = jti.make_resnet_from_torch(str(path), depth=50, image_size=32,
                                    max_batch_size=2,
                                    compute_dtype=jnp.float32)
    assert pm.name == jm.name == "resnet50"
    assert pm.batch_buckets == jm.batch_buckets
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with torch.inference_mode():
        got = pm.apply_fn(pm.params, {"input": torch.from_numpy(x)})[
            "logits"].numpy()
    want = np.asarray(jm.apply_fn(jm.params, {"input": x})["logits"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RN_TOL, atol=RN_TOL)


# ------------------------------------------------------------------- Llama
VOCAB, DM, HQ, HKV, DFF, NL = 64, 64, 4, 2, 96, 2
HD = DM // HQ
ROPE = 10000.0


def _llama_sd(seed=3, kind="numpy", lm_head=True):
    """An HF ``LlamaForCausalLM`` state_dict of seeded weights (tpulab's
    test's geometry: GQA, SwiGLU, untied head)."""
    rng = np.random.default_rng(seed)

    def lin(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    def ones():
        return (1 + rng.standard_normal(DM) * 0.1).astype(np.float32)

    sd = {"model.embed_tokens.weight": lin(VOCAB, DM),
          "model.norm.weight": ones()}
    if lm_head:
        sd["lm_head.weight"] = lin(VOCAB, DM)
    for i in range(NL):
        pre = f"model.layers.{i}"
        sd.update({
            f"{pre}.input_layernorm.weight": ones(),
            f"{pre}.post_attention_layernorm.weight": ones(),
            f"{pre}.self_attn.q_proj.weight": lin(HQ * HD, DM),
            f"{pre}.self_attn.k_proj.weight": lin(HKV * HD, DM),
            f"{pre}.self_attn.v_proj.weight": lin(HKV * HD, DM),
            f"{pre}.self_attn.o_proj.weight": lin(DM, DM),
            f"{pre}.mlp.gate_proj.weight": lin(DFF, DM),
            f"{pre}.mlp.up_proj.weight": lin(DFF, DM),
            f"{pre}.mlp.down_proj.weight": lin(DM, DFF),
        })
    if kind == "tensor":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    elif kind == "bf16":
        sd = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in sd.items()}
    return sd


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
@pytest.mark.parametrize("lm_head", [True, False], ids=["untied", "tied"])
def test_llama_params_equal_tpulabs(kind, lm_head):
    sd = _llama_sd(kind=kind, lm_head=lm_head)
    want = _np_tree(jti.llama_params_from_torch(sd, n_layers=NL))
    got = tti.llama_params_from_torch(sd, device="cpu")
    _same_tree(want, got)
    assert ("lm_head" in got) == lm_head
    q = sd["model.layers.0.self_attn.q_proj.weight"]
    q = q.float().numpy() if isinstance(q, torch.Tensor) else q
    assert np.array_equal(got["layer0"]["wqkv"][:, :HQ * HD].numpy(), q.T)


def test_llama_layer_count_mismatch_raises_as_tpulab():
    sd = _llama_sd()
    for mod, kw in ((jti, {}), (tti, {"device": "cpu"})):
        with pytest.raises(ValueError, match="n_layers=3 but the "
                           "checkpoint has 2 decoder layers"):
            mod.llama_params_from_torch(sd, n_layers=3, **kw)


def test_imported_llama_serves_tpulabs_tokens():
    """The imported tree in the port's batcher (both plans) gives the
    port's dense greedy stream and tpulab's batcher's, token for token."""
    import jax.numpy as jnp

    from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import make_generate_fn

    sd = _llama_sd()
    kw = dict(n_heads=HQ, n_layers=NL, n_kv_heads=HKV, rope_theta=ROPE)
    params = tti.llama_params_from_torch(sd, device="cpu")
    dense = make_generate_fn(params, max_len=48,
                             compute_dtype=torch.float32, **kw)
    jcb = JaxBatcher(jti.llama_params_from_torch(sd), lanes=1, max_len=48,
                     page_size=8, compute_dtype=jnp.float32, **kw)
    prompts = [np.asarray([5, 9, 2, 41], np.int32),
               np.random.default_rng(1).integers(0, VOCAB, (11,), np.int32)]
    try:
        want = [[int(t) for t in jcb.submit(p, 8).result(timeout=300)]
                for p in prompts]
    finally:
        jcb.shutdown()
    for ragged in (True, False):
        cb = ContinuousBatcher(params, lanes=1, max_len=48, page_size=8,
                               compute_dtype=torch.float32, device="cpu",
                               ragged=ragged, **kw)
        try:
            got = [[int(t) for t in cb.submit(p, 8).result(timeout=300)]
                   for p in prompts]
        finally:
            cb.shutdown()
        assert got == want
    assert [dense(p[None, :], 8)[0].tolist() for p in prompts] == want


def test_imported_llama_matches_hugging_face():
    transformers = pytest.importorskip("transformers")
    from tpulab_torch.models.transformer import transformer_apply

    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=DM, intermediate_size=DFF,
        num_hidden_layers=NL, num_attention_heads=HQ,
        num_key_value_heads=HKV, rope_theta=ROPE, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(cfg).eval()
    params = tti.llama_params_from_torch(hf.state_dict(), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, VOCAB, (2, 12)))
    with torch.inference_mode():
        want = hf(tokens).logits
        got = transformer_apply(params, {"tokens": tokens}, n_heads=HQ,
                                n_layers=NL, n_kv_heads=HKV,
                                rope_theta=ROPE,
                                compute_dtype=torch.float32)["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


# --------------------------------------------------------------------- ViT
V_IMG, V_PATCH, V_D, V_HEADS, V_LAYERS, V_FF, V_CLASSES = 32, 8, 48, 4, 2, \
    96, 10


def _vit_sd(seed=5, kind="numpy"):
    """An HF ``ViTForImageClassification`` state_dict of seeded weights."""
    rng = np.random.default_rng(seed)

    def w(*s, scale=0.05):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    n_pos = (V_IMG // V_PATCH) ** 2 + 1
    sd = {"vit.embeddings.cls_token": w(1, 1, V_D),
          "vit.embeddings.position_embeddings": w(1, n_pos, V_D),
          "vit.embeddings.patch_embeddings.projection.weight":
              w(V_D, 3, V_PATCH, V_PATCH),
          "vit.embeddings.patch_embeddings.projection.bias": w(V_D),
          "vit.layernorm.weight": 1 + w(V_D), "vit.layernorm.bias": w(V_D),
          "classifier.weight": w(V_CLASSES, V_D),
          "classifier.bias": w(V_CLASSES)}
    for i in range(V_LAYERS):
        pre = f"vit.encoder.layer.{i}"
        att = f"{pre}.attention.attention"
        for n in ("query", "key", "value"):
            sd[f"{att}.{n}.weight"] = w(V_D, V_D)
            sd[f"{att}.{n}.bias"] = w(V_D)
        sd.update({
            f"{pre}.layernorm_before.weight": 1 + w(V_D),
            f"{pre}.layernorm_before.bias": w(V_D),
            f"{pre}.layernorm_after.weight": 1 + w(V_D),
            f"{pre}.layernorm_after.bias": w(V_D),
            f"{pre}.attention.output.dense.weight": w(V_D, V_D),
            f"{pre}.attention.output.dense.bias": w(V_D),
            f"{pre}.intermediate.dense.weight": w(V_FF, V_D),
            f"{pre}.intermediate.dense.bias": w(V_FF),
            f"{pre}.output.dense.weight": w(V_D, V_FF),
            f"{pre}.output.dense.bias": w(V_D),
        })
    if kind == "tensor":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_vit_params_equal_tpulabs(kind):
    sd = _vit_sd(kind=kind)
    want = jti.vit_params_from_hf(sd, layer_norm_eps=1e-6,
                                  image_mean=(0.4, 0.5, 0.6))
    got = tti.vit_params_from_hf(sd, layer_norm_eps=1e-6,
                                 image_mean=(0.4, 0.5, 0.6), device="cpu")
    _same_tree(want, got)
    assert got["patch_embed"].shape == (V_PATCH * V_PATCH * 3, V_D)


@pytest.mark.parametrize("input_dtype", [np.float32, np.uint8],
                         ids=["float", "uint8"])
def test_make_vit_from_hf_serves_tpulabs_logits(tmp_path, input_dtype):
    """``make_vit_from_hf`` from a checkpoint file at f32: tpulab's
    model's logits within 1e-4 (uint8 input: the processor's 0.5 / 0.5
    normalization on both sides), and the Runtime's placed tree gives
    the direct forward's logits."""
    import jax.numpy as jnp

    from tpulab_torch.engine.runtime import Runtime

    path = tmp_path / "vit.pt"
    torch.save(_vit_sd(kind="tensor"), str(path))
    geo = dict(image_size=V_IMG, patch_size=V_PATCH, n_heads=V_HEADS,
               max_batch_size=2, input_dtype=input_dtype)
    pm = tti.make_vit_from_hf(str(path), compute_dtype=torch.float32,
                              device="cpu", **geo)
    jm = jti.make_vit_from_hf(str(path), compute_dtype=jnp.float32, **geo)
    assert pm.name == jm.name == f"vit_hf_{V_PATCH}"
    assert pm.batch_buckets == jm.batch_buckets
    rng = np.random.default_rng(7)
    x = (rng.integers(0, 256, (2, V_IMG, V_IMG, 3)).astype(np.uint8)
         if input_dtype == np.uint8 else
         rng.standard_normal((2, V_IMG, V_IMG, 3)).astype(np.float32))
    with torch.inference_mode():
        got = pm.apply_fn(pm.params, {"input": torch.from_numpy(x)})[
            "logits"]
    want = np.asarray(jm.apply_fn(jm.params, {"input": x})["logits"])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    compiled = Runtime("cpu").compile_model(pm)
    out = compiled(2, {"input": torch.from_numpy(x)})["logits"]
    np.testing.assert_allclose(out.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)


def test_make_vit_from_hf_refuses_bad_geometry_as_tpulab():
    sd = _vit_sd()
    for mod, kw in ((jti, {}), (tti, {"device": "cpu"})):
        with pytest.raises(ValueError, match="implies 65 positions"):
            mod.make_vit_from_hf(sd, image_size=V_IMG, patch_size=4,
                                 n_heads=V_HEADS, **kw)
        with pytest.raises(ValueError, match="not divisible"):
            mod.make_vit_from_hf(sd, image_size=V_IMG, patch_size=V_PATCH,
                                 n_heads=5, **kw)


def test_imported_vit_matches_hugging_face():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(
        image_size=V_IMG, patch_size=V_PATCH, hidden_size=V_D,
        num_hidden_layers=V_LAYERS, num_attention_heads=V_HEADS,
        intermediate_size=V_FF, num_labels=V_CLASSES, hidden_act="gelu",
        layer_norm_eps=1e-12, qkv_bias=True)
    torch.manual_seed(0)
    hf = transformers.ViTForImageClassification(cfg).eval()
    pm = tti.make_vit_from_hf(hf.state_dict(), image_size=V_IMG,
                              patch_size=V_PATCH, n_heads=V_HEADS,
                              compute_dtype=torch.float32, device="cpu",
                              max_batch_size=2)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3, V_IMG, V_IMG)).astype(np.float32))
    with torch.inference_mode():
        want = hf(pixel_values=x).logits
        got = pm.apply_fn(pm.params, {"input": x.permute(0, 2, 3, 1)
                                      .contiguous()})["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
