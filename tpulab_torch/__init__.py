"""tpulab_torch — the PyTorch/CUDA port of :mod:`tpulab` for NVIDIA Hopper.

The JAX package ``tpulab`` stays the reference; this package is its port,
module for module, with every Pallas TPU kernel on the ported path
replaced by a CUDA C++ kernel written for ``sm_90a``.  It imports
``torch`` and never ``jax`` or ``tpulab`` (``tests/test_torch_isolation.py``
holds that rule).

Layer map (mirrors tpulab's)::

    tpulab_torch.core     host utilities (deadlines)
    tpulab_torch.cuda     device layer (platform, tracked KV allocator)
    tpulab_torch.models   transformer + the weight bridge from tpulab trees
    tpulab_torch.ops      hand-written CUDA kernels and their plain versions
    tpulab_torch.engine   paged KV pool, paged programs, ContinuousBatcher

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no ``device="cpu"`` they raise.
The package import itself is lazy and loads nothing heavy.
"""

__version__ = "0.1.0"
