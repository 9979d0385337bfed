"""tpulab's bench rows of the host tiers against the port's, on the CPU.

As ``tests/test_torch_bench_rows.py`` does for the engine's rows: each row
runs once in tpulab and once in the port (``device="cpu"``, f32) on
tpulab's weights (``tree_from_numpy``), at a tiny width.  Held: equal key
sets, equal counts, both parity flags True, times and rates positive
floats.  Rows: ``benchmark_kv_offload`` (``tpulab_torch/kvcache``),
``benchmark_disagg`` (``tpulab_torch/disagg/bench.py``),
``benchmark_hbm_arbiter`` (``tpulab_torch/hbm``) and
``benchmark_multi_model`` (``tpulab_torch/modelstore``).

Where a row's count depends on when a thread's request meets the
scheduler, in tpulab as in the port, the test holds what the count must
equal given the others.  ``kv_offload``: each preemptor is submitted
once a low-priority token has streamed, so how many find a low lane to
evict (rather than one a finished request freed) varies between runs of
either package; the tier-off re-prefills and the tier-on swaps are at
most the preemptions, and the tier-on re-prefills are
tpulab's 0.
``hbm_arbiter``: how many lanes are live when the mid-burst model op
squeezes the pool sets the demotions, evictions, grows and shrinks; each
is at least 1 in both packages, and the denials and final pool size are
tpulab's.  The engine's bursts are queued whole before the scheduler's
pass in both packages (``torch_bench_util.settled_schedulers``).

Last, the engine's ``benchmark_decode_dispatch`` (its in-step bursts are
in ``tests/test_torch_bench_rows.py``) at phase 15's arguments with each
burst's head decoding before the rest are queued, the order the card
gives at 8B width (``torch_bench_util.head_first_bursts``).
"""

import pytest
import torch

from tpulab import disagg as jdisagg
from tpulab import hbm as jhbm
from tpulab import kvcache as jkv
from tpulab import modelstore as jms
from tpulab.engine import paged as jpaged
from tpulab_torch import disagg, hbm, kvcache, modelstore
from tpulab_torch.engine import paged
from torch_bench_util import (head_first_bursts, key_paths, port_tree,
                              positive_float, settled_schedulers)

torch.set_num_threads(2)

INIT = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=128)
GEO = dict(vocab=64, d_model=32, n_heads=2, n_layers=2)


# ---------------------------------------------------------------- kv_offload
KV = dict(GEO, lanes=2, steps=12, prompt_len=6, n_low=2, n_hi=2)


@pytest.fixture(scope="module")
def kv_offload():
    with settled_schedulers(jpaged, paged):
        return (jkv.benchmark_kv_offload(**KV),
                kvcache.benchmark_kv_offload(
                    **KV, params=port_tree(**INIT), device="cpu"))


def test_kv_offload_keys_and_geometry(kv_offload):
    ref, got = kv_offload
    assert key_paths(got) == key_paths(ref)
    for k in ("lanes", "steps", "n_requests", "pool_pages"):
        assert got[k] == ref[k]
    assert round(got["oversubscription"], 2) == ref["oversubscription"]


@pytest.mark.parametrize("mode", ["tier_off", "tier_on"])
def test_kv_offload_counts(kv_offload, mode):
    """Tier off: a preempted lane re-prefills once (one preempted before
    its prompt ran pays nothing).  Tier on: none re-prefills (tpulab's
    0); every snapshot taken is restored, none fails."""
    for row in kv_offload:
        e = row[mode]
        assert 1 <= e["preemptions"] <= KV["n_hi"]
        if mode == "tier_off":
            assert 0 <= e["re_prefill_dispatches"] <= e["preemptions"]
        else:
            assert e["re_prefill_dispatches"] == 0
            assert e["swap_outs"] == e["swap_ins"] <= e["preemptions"]
            assert e["swap_failures"] == 0
            assert e["recompute_tokens_saved"] > 0
    got = kv_offload[1][mode]
    assert positive_float(got["goodput_rps"])
    assert positive_float(got["wall_s"])


# -------------------------------------------------------------------- disagg
DG = dict(GEO, lanes=2, n_requests=3, prompt_len=12, steps=4)


@pytest.fixture(scope="module")
def disagg_rows():
    with settled_schedulers(jpaged, paged):
        return (jdisagg.benchmark_disagg(**DG),
                disagg.benchmark_disagg(
                    **DG, params=port_tree(**INIT), device="cpu"))


def test_disagg_keys_and_parity(disagg_rows):
    ref, got = disagg_rows
    assert key_paths(got) == key_paths(ref)
    assert ref["token_parity"] is True and got["token_parity"] is True


def test_disagg_counts(disagg_rows):
    """The unified pool prefills every request (and the warm-up); the
    decode batcher prefills none; every request ships once, nothing
    fails, and the wire's megabytes are tpulab's."""
    ref, got = disagg_rows
    assert got["unified"]["prefill_dispatches"] == \
        ref["unified"]["prefill_dispatches"] == DG["n_requests"] + 1
    for k in ("decode_prefill_dispatches", "shipments", "ship_failures"):
        assert got["disagg"][k] == ref["disagg"][k]
    assert got["disagg"]["decode_prefill_dispatches"] == 0
    assert got["disagg"]["shipments"] == DG["n_requests"]
    assert round(got["disagg"]["ship_mb"], 2) == ref["disagg"]["ship_mb"]
    for mode in ("unified", "disagg"):
        e = got[mode]
        assert positive_float(e["goodput_rps"])
        assert positive_float(e["wall_s"])
        assert 0.0 <= e["itl_ms_p50"] <= e["itl_ms_p99"]


# --------------------------------------------------------------- hbm_arbiter
HB = dict(GEO, lanes=2, steps=6, prompt_len=6, n_llm=4)


@pytest.fixture(scope="module")
def hbm_rows():
    with settled_schedulers(jpaged, paged):
        return (jhbm.benchmark_hbm_arbiter(**HB),
                hbm.benchmark_hbm_arbiter(
                    **HB, params=port_tree(**INIT), device="cpu"))


def test_hbm_arbiter_keys_and_parity(hbm_rows):
    ref, got = hbm_rows
    assert key_paths(got) == key_paths(ref)
    assert ref["parity"] is True and got["parity"] is True
    for k in ("lanes", "steps", "n_llm", "small_pages", "full_pages"):
        assert got[k] == ref[k]


def test_hbm_arbiter_counts(hbm_rows):
    """Both pressure directions fire (demotions and evictions) and the
    pool grows and shrinks back, in both; the denials (none) and the final
    pool size equal tpulab's; the static split's preemptions too."""
    ref, got = hbm_rows
    for k in ("denials", "pool_pages_final"):
        assert got["arbiter_on"][k] == ref["arbiter_on"][k], k
    for row in hbm_rows:
        for k in ("demotions", "evictions", "grows", "shrinks"):
            assert row["arbiter_on"][k] >= 1, k
    for k in ("preemptions", "pool_pages_final"):
        assert got["static_split"][k] == ref["static_split"][k], k
    assert round(got["arbiter_on"]["free_hbm_mb"], 3) == \
        ref["arbiter_on"]["free_hbm_mb"]
    for mode in ("arbiter_on", "static_split"):
        assert positive_float(got[mode]["goodput_ops_s"])
    assert positive_float(got["goodput_ratio"])


# --------------------------------------------------------------- multi_model
MM = dict(switches=4, steps=4, prompt_len=5, vocab=64, d_model=32,
          n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def multi_model_rows():
    with settled_schedulers(jpaged, paged):
        return (jms.benchmark_multi_model(**MM),
                modelstore.benchmark_multi_model(
                    **MM, params=port_tree(**INIT), device="cpu"))


def test_multi_model_keys_and_parity(multi_model_rows):
    ref, got = multi_model_rows
    assert key_paths(got) == key_paths(ref)
    for k in ("parity", "llm_parity", "vit_parity"):
        assert ref[k] is True and got[k] is True, k


def test_multi_model_counts(multi_model_rows):
    """Every switch swaps: evictions, swap-ins, swap-outs and (none) cold
    rebuilds equal tpulab's, under the same budget (ViT-S at 32 x 32 plus
    half the LLM); the baseline cold-builds, the multiplexer swaps in."""
    ref, got = multi_model_rows
    for k in ("evictions", "swap_ins", "swap_outs", "cold_rebuilds"):
        assert got["mux_on"][k] == ref["mux_on"][k], k
    assert got["mux_on"]["cold_rebuilds"] == 0
    assert round(got["mux_on"]["hbm_budget_mb"], 2) == \
        ref["mux_on"]["hbm_budget_mb"]
    assert positive_float(got["mux_on"]["swap_in_ms_mean"])
    assert got["mux_on"]["cold_build_ms_mean"] is None
    assert positive_float(got["mux_off"]["cold_build_ms_mean"])
    assert got["mux_off"]["swap_in_ms_mean"] is None
    assert isinstance(got["swap_in_faster_than_cold_build"], bool)


# ------------------------------------------- decode_dispatch, head first
DS = dict(GEO, ks=(1, 4, 8, 16), lanes=4, steps=48, prompt_len=8)


@pytest.fixture(scope="module")
def decode_dispatch_head_first():
    with head_first_bursts(DS["lanes"], jpaged, paged):
        return (jpaged.benchmark_decode_dispatch(**DS),
                paged.benchmark_decode_dispatch(
                    **DS, params=port_tree(**INIT), device="cpu"))


@pytest.mark.parametrize("k", DS["ks"][1:])
def test_decode_dispatch_counts_head_first(decode_dispatch_head_first, k):
    """Phase 15's arguments with each burst's first request decoding
    before the rest are queued, as at 8B width on the card: dispatch-ahead
    keeps re-dispatching the lane set it has until a lane finishes, so
    the head decodes alone to its end and the other three follow.  tpulab
    does the same: twice an in-step burst's dispatches at every K > 1
    (K = 1 dispatches no block ahead and is left to thread timing)."""
    ref, got = (r["k"][str(k)] for r in decode_dispatch_head_first)
    for key in ("dispatches", "host_syncs"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    assert got["dispatches"] == 2 * -(-(DS["steps"] - 1) // k)
    assert ref["parity_vs_k1"] is True and got["parity_vs_k1"] is True
