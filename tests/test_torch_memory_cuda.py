"""Card-only cases of the memory side of the device layer (no JAX here:
``python -m pytest --noconftest -m cuda tests/test_torch_memory_cuda.py``
on the card).  Their CPU counterparts are in
``tests/test_torch_device_layer.py``."""

import pytest
import torch

import tpulab_torch.memory as tm
from tpulab_torch.cuda import make_cuda_allocator, make_staging_allocator
from tpulab_torch.cuda.cyclic_buffer import CudaCyclicWindowedStack
from tpulab_torch.engine.buffers import Buffers
from tpulab_torch.memory.descriptor import host_view

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_staging_views_are_page_locked(card):
    st = make_staging_allocator()
    addr = st.allocate_node(1 << 20)
    view = torch.frombuffer(host_view(addr, 1 << 20), dtype=torch.uint8)
    assert view.is_pinned() and addr % 4096 == 0
    st.deallocate_node(addr, 1 << 20)
    assert st._registered == set()
    buffers = Buffers(1024, block_size=1024)
    assert all(buffers._carve(800).is_pinned() for _ in range(2))
    assert buffers._stack.depth == 2
    buffers.release()


def test_device_blocks_count_in_memory_allocated(card):
    raw = make_cuda_allocator()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    arena = tm.BlockArena(tm.FixedSizeBlockAllocator(raw, 1 << 20))
    b = arena.allocate_block()
    assert torch.cuda.memory_allocated() - base == 1 << 20
    arena.deallocate_block(b)
    arena.shrink_to_fit()
    assert torch.cuda.memory_allocated() == base
    assert raw.live_allocations == 0


def test_device_stack_streams_the_appended_bytes(card):
    data = torch.randint(0, 1 << 30, (4096,), dtype=torch.int32)
    buf = tm.make_allocator(make_staging_allocator()).allocate_descriptor(
        (3 * 192 + 64) * 4)
    seen = {}
    stack = CudaCyclicWindowedStack(
        buf, 3, 256 * 4, 64 * 4, dtype=torch.int32,
        compute_fn=lambda w, d: seen.setdefault(w, d.clone()))
    stack.append(data.numpy().tobytes())
    stack.sync_all()
    stack.release()
    assert len(seen) == (4096 - 64) // 192
    for w, d in seen.items():
        assert d.is_cuda and torch.equal(d.cpu(), data[w * 192:w * 192 + 256])
