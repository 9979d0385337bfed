"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

- :mod:`flash_attention` — blockwise-softmax attention over (B, T, H, D),
  the split plan's full-prompt prefill (``attention_fn`` for the
  transformer); differentiable
- :mod:`ragged_attention` — the ragged paged-attention kernel family:
  per-lane ``(q_len, kv_len)`` segments serve decode, verify and chunked
  prefill over block tables
- :mod:`paged_attention` — the single-query decode walk over block tables

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor.
"""

from tpulab_torch.ops.flash_attention import (flash_attention,
                                              make_flash_attention_fn)
from tpulab_torch.ops.paged_attention import paged_decode_attention
from tpulab_torch.ops.ragged_attention import ragged_paged_attention

__all__ = ["flash_attention", "make_flash_attention_fn",
           "paged_decode_attention", "ragged_paged_attention"]
