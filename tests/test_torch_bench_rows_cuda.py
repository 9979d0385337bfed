"""The bench rows' card-only options (marked ``cuda``: they skip without a
card).  On the card the rows' attention is the hand-written kernels, so
their launches are counted: ``benchmark_decode_kernel_vs_gather`` runs
kernel 1 ``n_layers`` x 3 x ``iters`` times on its kernel side and never on
its gather side, and names the body and split count its launches ran;
``benchmark_llm_decode`` runs kernel 1 in both trees; the split plan of
``benchmark_ragged_attention``'s ``legacy`` mode prefills on the flash
kernel (kernel 2), ``n_layers`` launches a prefill forward.  No JAX here:
run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_bench_rows_cuda.py``.
"""

import pytest
import torch

from tpulab_torch.engine import paged
from tpulab_torch.ops.flash_attention import flash_attention
from tpulab_torch.ops.ragged_attention import ragged_paged_attention

WIDTH = dict(d_model=256, n_heads=4, n_layers=2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_kernel_vs_gather_counts_its_launches():
    _card()
    n0 = ragged_paged_attention.launches
    g0 = dict(ragged_paged_attention.launches_by_geom)
    row = paged.benchmark_decode_kernel_vs_gather(
        **WIDTH, page_size=32, lanes=8, ctx=512, iters=4,
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert "kernel_error" not in row and "gather_error" not in row
    assert ragged_paged_attention.launches - n0 == 2 * 3 * 4
    ran = {g: n - g0.get(g, 0)
           for g, n in ragged_paged_attention.launches_by_geom.items()
           if n > g0.get(g, 0)}
    # one geometry for every launch, the one the row names
    assert ran == {row["kernel_geom"]: 2 * 3 * 4}
    assert row["kernel_geom"].startswith("fma x")   # f32 q: f32 params
    assert row["kernel_tok_s"] > 0 and row["gather_tok_s"] > 0


@pytest.mark.cuda
def test_llm_decode_runs_kernel_1_in_both_trees():
    _card()
    n0 = ragged_paged_attention.launches
    row = paged.benchmark_llm_decode(n_heads=4, n_kv_heads=2, n_layers=2,
                                     d_model=256, d_ff=512, vocab=512,
                                     lanes=2, ctx=256, iters=3)
    torch.cuda.synchronize()
    assert "bf16_error" not in row and "int8_error" not in row
    assert ragged_paged_attention.launches - n0 == 2 * 2 * 3 * 3
    assert row["int8_param_mb"] < row["bf16_param_mb"]


@pytest.mark.cuda
def test_ragged_attention_legacy_prefills_on_the_flash_kernel():
    _card()
    made = []
    base = paged.ContinuousBatcher

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    paged.ContinuousBatcher = Recorded
    f0, r0 = flash_attention.launches, ragged_paged_attention.launches
    try:
        row = paged.benchmark_ragged_attention(**WIDTH, lanes=2, steps=8,
                                               prompt_len=6)
    finally:
        paged.ContinuousBatcher = base
    torch.cuda.synchronize()
    legacy, ragged = made
    assert "error" not in row["legacy"] and "error" not in row["ragged_kernel"]
    assert legacy.prefill_forwards > 0 and ragged.prefill_forwards == 0
    assert flash_attention.launches - f0 == 2 * legacy.prefill_forwards
    assert ragged_paged_attention.launches - r0 == 2 * (
        legacy.forward_steps + ragged.forward_steps)
