"""tpulab's bench rows of the serving engine against the port's, on the CPU.

Each row runs once in tpulab (its own draw of its weights, f32 unless the
row says otherwise) and once in the port (``device="cpu"``) on the same
weights, brought over by ``tree_from_numpy``, at tpulab's arguments cut
to a tiny width (d_model <= 64, 1-3 layers, a few steps).  Held:

- the key sets are equal, apart from the port's documented omissions
  (tpulab's gather-plan ``ragged`` mode, whose counts the port's
  ``ragged_kernel`` is held to; the ``g_pages`` x ``nbuf`` autotune);
- every count is equal: dispatches, host syncs, syncs per token,
  tokens per dispatch, drafted / accepted / acceptance, the dense row's
  rounds, ``dispatch_kinds`` (tpulab rounds ratios, so the port's are
  rounded the same way before they are compared);
- every parity flag is True in both;
- tok/s, seconds and megabytes are positive floats (a CPU time is never
  compared with another).

Rows: ``benchmark_decode_dispatch``, ``_speculative_decode``,
``_ragged_attention`` (tpulab's ``kernel=False``: its ``ragged`` mode is
the port's ragged plan; the Pallas interpreter is too slow for tier 1),
``_llm_decode``, ``_decode_kernel_vs_gather`` and ``_sweep``
(``tpulab_torch/engine/paged.py``) and the dense ``benchmark_speculative``
(``tpulab_torch/engine/speculative.py``).  The host-tier rows are in
``tests/test_torch_bench_rows_host.py``, with ``decode_dispatch`` at
phase 15's arguments in the card's order of submits; the card-only
options in ``tests/test_torch_bench_rows_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from tpulab.engine import paged as jpaged
from tpulab.engine import speculative as jspec
from tpulab.models.transformer import init_transformer_params as jax_init
from tpulab_torch.engine import paged, speculative
from torch_bench_util import (key_paths, port_tree, positive_float,
                              settled_schedulers)

torch.set_num_threads(2)


def same_counts(port, ref, keys, digits=None):
    """``port[k] == ref[k]`` for every k, the port's ratios rounded to
    ``digits[k]`` places as tpulab rounds them."""
    digits = digits or {}
    for k in keys:
        got = port[k]
        if k in digits:
            got = round(got, digits[k])
        assert got == ref[k], (k, port[k], ref[k])


# ------------------------------------------------------------ decode_dispatch
DD = dict(ks=(1, 4, 8), lanes=2, steps=10, prompt_len=5, d_model=32,
          n_heads=2, n_layers=2, vocab=64)
DD_INIT = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=128)


@pytest.fixture(scope="module")
def decode_dispatch():
    with settled_schedulers(jpaged, paged):
        return (jpaged.benchmark_decode_dispatch(**DD),
                paged.benchmark_decode_dispatch(
                    **DD, params=port_tree(**DD_INIT), device="cpu"))


def test_decode_dispatch_keys(decode_dispatch):
    ref, got = decode_dispatch
    assert key_paths(got) == key_paths(ref)


@pytest.mark.parametrize("k", DD["ks"])
def test_decode_dispatch_counts(decode_dispatch, k):
    """Per K: dispatches, host syncs and syncs per token equal tpulab's,
    greedy parity against K=1 in both, tok/s a positive float."""
    ref, got = (r["k"][str(k)] for r in decode_dispatch)
    same_counts(got, ref, ("dispatches", "host_syncs", "syncs_per_token"),
                {"syncs_per_token": 4})
    if k != 1:
        assert ref["parity_vs_k1"] is True and got["parity_vs_k1"] is True
    assert positive_float(got["tok_s"])
    assert positive_float(decode_dispatch[1]["best_tok_s"])


# ------------------------------------------------------- speculative_decode
SD = dict(k=4, lanes=2, steps=12, prompt_len=5, d_model=32, n_heads=2,
          n_layers=3, draft_layers=1, vocab=64)
SD_INIT = dict(vocab=64, d_model=32, n_heads=2, n_layers=3, d_ff=128)


@pytest.fixture(scope="module")
def speculative_decode():
    tree = port_tree(**SD_INIT)
    wo = tree["layer2"]["wo"].clone()
    with settled_schedulers(jpaged, paged):
        got = paged.benchmark_speculative_decode(**SD, params=tree,
                                                 device="cpu")
        ref = jpaged.benchmark_speculative_decode(**SD)
    # tail_scale multiplies new tensors: the caller's tree is untouched
    assert torch.equal(tree["layer2"]["wo"], wo)
    return ref, got


def test_speculative_decode_keys(speculative_decode):
    ref, got = speculative_decode
    assert key_paths(got) == key_paths(ref)


@pytest.mark.parametrize("mode", ["plain", "spec"])
def test_speculative_decode_counts(speculative_decode, mode):
    """Dispatches, host syncs, tokens per dispatch, syncs per token and
    (spec) drafted / accepted / acceptance / fallbacks equal tpulab's;
    spec and plain give the same greedy tokens in both."""
    ref, got = (r[mode] for r in speculative_decode)
    keys = ["dispatches", "host_syncs", "tokens_per_dispatch",
            "syncs_per_token"]
    if mode == "spec":
        keys += ["drafted", "accepted", "acceptance", "fallbacks"]
    same_counts(got, ref, keys, {"tokens_per_dispatch": 2,
                                 "syncs_per_token": 4, "acceptance": 3})
    assert positive_float(got["tok_s"])
    assert all(r["parity"] is True for r in speculative_decode)
    assert positive_float(speculative_decode[1]["uplift"])


def test_speculative_decode_warms_every_block_size(monkeypatch):
    """Every ``BLOCK_K_MENU`` size <= k of the mode runs once on a zero
    throwaway pool before the timed window (K=1 plain excepted)."""
    seen = []
    for name in ("paged_decode_block", "paged_speculative_block"):
        real = getattr(paged, name)

        def spy(*a, _real=real, _name=name, **kw):
            if not torch.count_nonzero(a[2] if "spec" in _name else a[1]):
                seen.append((_name, kw["k"]))
            return _real(*a, **kw)
        monkeypatch.setattr(paged, name, spy)
    paged.benchmark_speculative_decode(**dict(SD, steps=4),
                                       params=port_tree(**SD_INIT),
                                       device="cpu")
    assert ("paged_decode_block", 2) in seen
    assert ("paged_decode_block", 4) in seen
    assert {k for n, k in seen if n == "paged_speculative_block"} >= {
        1, 2, 4}


# ---------------------------------------------------------- ragged_attention
RA = dict(lanes=2, steps=8, prompt_len=5, d_model=32, n_heads=2, n_layers=2,
          vocab=64)
RA_INIT = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=128)
WINDOWS = ("all_prefill", "all_decode")     # the deterministic windows


@pytest.fixture(scope="module")
def ragged_attention():
    with settled_schedulers(jpaged, paged):
        return (jpaged.benchmark_ragged_attention(**RA, kernel=False),
                paged.benchmark_ragged_attention(
                    **RA, params=port_tree(**RA_INIT), device="cpu"))


def test_ragged_attention_keys(ragged_attention):
    """The port's ``ragged_kernel`` mode stands where tpulab's gather-plan
    ``ragged`` mode stood; every other key is tpulab's."""
    ref, got = ragged_attention
    renamed = {("ragged" + p[len("ragged_kernel"):]
                if p.startswith("ragged_kernel") else p)
               for p in key_paths(got)}
    assert renamed == key_paths(ref)


@pytest.mark.parametrize("mode,ref_mode", [("legacy", "legacy"),
                                           ("ragged_kernel", "ragged")])
@pytest.mark.parametrize("window", WINDOWS)
def test_ragged_attention_windows(ragged_attention, mode, ref_mode, window):
    ref, got = ragged_attention
    same_counts(got[mode][window], ref[ref_mode][window],
                ("dispatches", "host_syncs", "syncs_per_token"),
                {"syncs_per_token": 4})
    assert positive_float(got[mode][window]["tok_s"])
    assert positive_float(got[mode]["mixed"]["tok_s"])


def test_ragged_attention_dispatch_kinds_and_parity(ragged_attention):
    """``dispatch_kinds`` equal tpulab's in both modes; every dispatch of
    the port goes through the ragged kernel family (tpulab's legacy mode
    and its ``ragged`` mode's decode blocks ran the XLA gather, so its
    ``ragged_dispatches`` count only the mixed rounds); the prefill fold
    and the token parity equal tpulab's."""
    ref, got = ragged_attention
    for mode, ref_mode in (("legacy", "legacy"), ("ragged_kernel", "ragged")):
        assert got[mode]["dispatch_kinds"] == ref[ref_mode]["dispatch_kinds"]
        assert got[mode]["ragged_dispatches"] == sum(
            got[mode]["dispatch_kinds"].values())
    assert ref["ragged"]["ragged_dispatches"] == \
        ref["ragged"]["dispatch_kinds"]["mixed"]
    assert got["prefill_fold"] == ref["prefill_fold"]
    assert got["prefill_fold"]["ragged_dispatches"] < \
        got["prefill_fold"]["legacy_dispatches"]
    assert ref["ragged"]["parity"] is True
    assert got["ragged_kernel"]["parity"] is True


# ---------------------------------------------------------------- llm_decode
LD = dict(n_heads=4, n_kv_heads=2, n_layers=2, d_model=32, d_ff=64, vocab=64,
          page_size=8, lanes=2, ctx=32, iters=3)
LD_INIT = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=64, tie_embeddings=False)


def test_llm_decode_row():
    """bf16 against int8: tpulab's keys, both tok/s positive, and the
    parameter megabytes of each tree equal tpulab's at its rounding (the
    int8 tree smaller)."""
    ref = jpaged.benchmark_llm_decode(**LD)
    got = paged.benchmark_llm_decode(**LD, params=port_tree(**LD_INIT),
                                     device="cpu")
    assert set(got) == set(ref)
    for label in ("bf16", "int8"):
        assert positive_float(got[f"{label}_tok_s"])
        assert round(got[f"{label}_param_mb"], 1) == ref[f"{label}_param_mb"]
    assert got["int8_param_mb"] < got["bf16_param_mb"]
    # the byte counts themselves (tpulab's rounding hides them at this
    # width), from tpulab's numpy tree: quantized matrices at one byte an
    # entry plus a bf16 scale per column, every other leaf at bf16's two
    np_tree = jax.tree_util.tree_map(np.asarray, jax_init(**LD_INIT))
    bf16 = int8 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_tree)[0]:
        name = jax.tree_util.keystr(path)
        bf16 += 2 * leaf.size
        quantized = any(f"'{k}'" in name for k in (
            "wqkv", "wo", "w1", "w2", "w3", "lm_head"))
        int8 += leaf.size + 2 * leaf.shape[-1] if quantized else \
            2 * leaf.size
    assert got["bf16_param_mb"] * 2**20 == bf16
    assert got["int8_param_mb"] * 2**20 == int8


# ------------------------------------------------- kernel vs gather, sweep
KG = dict(n_heads=2, n_layers=1, d_model=32, page_size=8, lanes=2, ctx=32,
          iters=2)
KG_INIT = dict(vocab=256, d_model=32, n_heads=2, n_layers=1, d_ff=128)


def test_decode_kernel_vs_gather_row():
    """tpulab's keys; the kernel side and the gather side both time; on the
    CPU ``kernel_geom`` says the wrapper ran its plain version."""
    ref = jpaged.benchmark_decode_kernel_vs_gather(**KG, autotune=False)
    got = paged.benchmark_decode_kernel_vs_gather(
        **KG, params=port_tree(**KG_INIT), device="cpu")
    assert set(got) == set(ref)
    assert (got["b"], got["ctx"]) == (ref["b"], ref["ctx"])
    assert positive_float(got["kernel_tok_s"])
    assert positive_float(got["gather_tok_s"])
    assert got["kernel_geom"] == "plain"


def test_gather_step_matches_the_kernel_step():
    """The row's gather comparator computes what the kernel step computes
    (tpulab's XLA fallback math against the ragged family's plain
    version), and writes the same pool."""
    torch.manual_seed(0)
    tree = port_tree(**dict(KG_INIT, n_heads=4, n_kv_heads=2))
    pools = [paged.PagedKVPool(9, 8, 1, 2, 8, torch.float32, "cpu")
             for _ in range(2)]
    base = torch.randn_like(pools[0].kv)
    for p in pools:
        p.kv.copy_(base)
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    args = (tables, torch.tensor([5, 30], dtype=torch.int32),
            torch.tensor([3, 7]), torch.tensor([True, True]))
    kw = dict(n_heads=4, n_layers=1, compute_dtype=torch.float32,
              n_kv_heads=2)
    a = paged.paged_decode_step(tree, pools[0].kv, *args, **kw)
    b = paged._gather_decode_step(tree, pools[1].kv, *args, **kw)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(pools[0].kv, pools[1].kv)


def test_decode_kernel_sweep_rows(monkeypatch):
    """The sweep hands each (lanes, context) combo to the row with tpulab's
    iteration scaling; tpulab's per-combo ``autotune`` is the only argument
    the port leaves out (decisions: g_pages / nbuf).  Both rows are
    stubbed: at a tiny context the scaling asks for 10^5 steps."""
    def recorder(calls):
        def row(**kw):
            calls.append(kw)
            return {"b": kw["lanes"], "ctx": kw["ctx"]}
        return row

    ref_calls, got_calls = [], []
    monkeypatch.setattr(jpaged, "benchmark_decode_kernel_vs_gather",
                        recorder(ref_calls))
    monkeypatch.setattr(paged, "benchmark_decode_kernel_vs_gather",
                        recorder(got_calls))
    ref = jpaged.benchmark_decode_kernel_sweep()
    got = paged.benchmark_decode_kernel_sweep(device="cpu")
    assert got == ref == [{"b": b, "ctx": c} for b, c in (
        (8, 2048), (32, 2048), (8, 8192), (8, 16384))]
    assert [c["iters"] for c in got_calls] == [
        c["iters"] for c in ref_calls] == [256, 64, 64, 32]
    shared = ("n_heads", "n_layers", "d_model", "page_size", "lanes", "ctx",
              "dtype")
    for r, g in zip(ref_calls, got_calls):
        assert {k: g[k] for k in shared} == {k: r[k] for k in shared}
        assert "autotune" not in g and g["device"] == "cpu"
    assert [c["autotune"] for c in ref_calls] == [True, True, True, False]


def test_autotune_is_refused():
    with pytest.raises(NotImplementedError, match="g_pages"):
        paged.benchmark_decode_kernel_vs_gather(**KG, autotune=True,
                                                device="cpu")


def test_use_kernel_false_still_raises_on_the_batcher():
    """The gather comparator is the rows' alone: the batcher keeps
    refusing tpulab's escape hatch."""
    with pytest.raises(NotImplementedError, match="use_kernel=False"):
        paged.ContinuousBatcher(port_tree(**KG_INIT), n_heads=2,
                                n_layers=1, device="cpu", use_kernel=False)


# ------------------------------------------------------ dense speculative
SP = dict(n_heads=2, n_layers=3, d_model=32, d_ff=64, vocab=64,
          draft_layers=1, k=3, steps=16, prompt_len=5, max_len=64)
SP_INIT = dict(vocab=64, d_model=32, n_heads=2, n_layers=3, d_ff=64, seed=0)


def test_dense_speculative_row():
    """``exact_match`` in both, ``acceptance`` and ``rounds`` equal
    tpulab's (tests/test_serving_extras.py reads these keys)."""
    ref = jspec.benchmark_speculative(**SP)
    got = speculative.benchmark_speculative(
        **SP, params=port_tree(**SP_INIT), device="cpu")
    assert set(got) == set(ref)
    assert ref["exact_match"] is True and got["exact_match"] is True
    same_counts(got, ref, ("k", "draft_layers", "n_layers", "steps",
                           "rounds", "acceptance"), {"acceptance": 3})
    for key in ("spec_tok_s", "plain_tok_s", "speedup"):
        assert positive_float(got[key])
