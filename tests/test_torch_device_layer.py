"""The device layer's memory side (``tpulab_torch.cuda``) held against
``tpulab.tpu`` on the CPU: memory kinds, the device RawAllocator under the
framework's arenas, the staging allocator, the copies, ``DeviceInfo``,
the public names, and ``Buffers`` carving from the framework (a second
block for a view past the first, as tpulab's).  The card-only cases are
in ``tests/test_torch_memory_cuda.py``, which imports no JAX."""

import numpy as np
import pytest
import torch

import tpulab.memory as jm
import tpulab.tpu as jt
import tpulab_torch.cuda as tc
import tpulab_torch.memory as tm
from tpulab.engine.buffers import Buffers as JaxBuffers
from tpulab_torch.cuda.device_info import DeviceInfo
from tpulab_torch.engine.buffers import Buffers
from tpulab_torch.memory.descriptor import host_view

#: tpulab.tpu's names -> tpulab_torch.cuda's (the device kinds renamed)
RENAMES = {"TpuMemory": "CudaMemory",
           "make_tpu_memory_type": "make_cuda_memory_type",
           "TpuRawAllocator": "DeviceRawAllocator",
           "make_tpu_allocator": "make_cuda_allocator",
           "tpu_sync_standard": "cuda_sync_standard",
           "tpu_sync_async": "cuda_sync_async", "TpuSync": "CudaSync",
           "is_tpu": "is_cuda"}


def test_public_names_match_tpulab_tpu():
    assert [RENAMES.get(n, n) for n in jt.__all__] == tc.__all__
    for name in tc.__all__:
        assert getattr(tc, name) is not None


def test_memory_kinds():
    assert not tc.CudaMemory.host_accessible
    assert (tc.CudaMemory.min_allocation_alignment,
            tc.CudaMemory.access_alignment) == (256, 256)
    assert int(tc.CudaMemory.device_type) == int(tm.DLDeviceType.kDLCUDA) == 2
    # the staging kind is tpulab's, field for field
    for f in ("name", "min_allocation_alignment", "access_alignment",
              "host_accessible"):
        assert getattr(tc.HostPinnedMemory, f) == getattr(jt.HostPinnedMemory, f)
    assert int(tc.HostPinnedMemory.device_type) == int(
        jt.HostPinnedMemory.device_type) == 3
    per_dev = tc.make_cuda_memory_type(3)
    assert per_dev.name == "cuda:3" == jt.make_tpu_memory_type(3).name.replace(
        "tpu", "cuda")
    assert not per_dev.host_accessible


def test_raw_allocator_blocks():
    """tpulab's ``test_tpu_raw_allocator_blocks`` on the CPU."""
    raw = tc.make_cuda_allocator("cpu")
    assert raw.memory_type is tc.CudaMemory and raw.max_alignment() == 256
    addr = raw.allocate_node(1024)
    buf = raw.buffer(addr)
    assert buf.shape == (1024,) and buf.dtype == torch.uint8
    assert int(buf.abs().sum()) == 0                       # zeroed
    assert raw.buffer(addr + 512) is buf                   # inside the block
    assert raw.bytes_in_use == 1024 and raw.live_allocations == 1
    assert tc.DeviceRawAllocator.total_bytes_in_use() >= 1024
    raw.deallocate_node(addr)
    assert raw.live_allocations == 0 and raw.bytes_in_use == 0
    with pytest.raises(tm.OutOfMemory):
        raw.allocate_node(0)
    for bad in (lambda: raw.buffer(addr), lambda: raw.deallocate_node(addr)):
        with pytest.raises(Exception) as e:
            bad()
        assert type(e.value).__name__ == "InvalidPointer"
    assert raw.max_node_size() == jt.TpuRawAllocator.max_node_size(
        jt.make_tpu_allocator())


def _compose(mem, raw):
    """tpulab's arena / transactional / best-fit sequence over device
    blocks; returns the observations (offsets, counts, never addresses)."""
    out = []
    arena = mem.BlockArena(mem.FixedSizeBlockAllocator(raw, 4096), cached=True)
    b = arena.allocate_block()
    arena.deallocate_block(b)
    b2 = arena.allocate_block()
    out += [b.size, b2.addr == b.addr, raw.live_allocations]
    arena.deallocate_block(b2)
    out.append(arena.shrink_to_fit())
    out.append(raw.live_allocations)
    t = mem.TransactionalAllocator(mem.FixedSizeBlockAllocator(raw, 4096))
    a1, a2 = t.allocate_node(1024), t.allocate_node(1024)
    a3 = t.allocate_node(3000)
    out += [a2 - a1, t.live_stacks, raw.live_allocations]
    for a in (a1, a2, a3):
        t.deallocate_node(a)
    out.append(t.shrink_to_fit())
    bf = mem.BFitAllocator(mem.FixedSizeBlockAllocator(raw, 1 << 16))
    x, y, z = (bf.allocate_node(n) for n in (1000, 2000, 500))
    bf.deallocate_node(y)
    w = bf.allocate_node(1500, alignment=256)
    out += [y - x, z - x, w - x, w % 256]
    for v in (x, z, w):
        bf.deallocate_node(v)
    out += [bf.free_bytes, raw.live_allocations]
    return out


def test_allocator_composes_with_framework_like_tpulab():
    raw = tc.make_cuda_allocator("cpu")
    got = _compose(tm, raw)
    assert got == _compose(jm, jt.make_tpu_allocator())
    assert got[:5] == [4096, True, 1, 4096, 0]


def test_device_descriptor_carries_its_tensor():
    raw = tc.make_cuda_allocator("cpu")
    alloc = tm.make_allocator(raw)
    d = alloc.allocate_descriptor(512)
    assert d.memory_type is tc.CudaMemory
    assert isinstance(d.device_buffer, torch.Tensor)
    assert d.device_buffer.numel() == 512 and d.alignment == 256
    with pytest.raises(TypeError):
        d.memoryview()                       # device memory: no host view
    d.release()
    assert d.device_buffer is None and raw.live_allocations == 0
    host = tm.make_allocator(tm.MallocAllocator()).allocate_descriptor(64)
    assert host.device_buffer is None
    host.release()


def test_staging_allocator_alignment_and_first_touch():
    """tpulab's ``test_staging_allocator_pinned_properties`` on both."""
    out = {}
    for pkg, alloc in (("tpulab", jt.make_staging_allocator()),
                       ("port", tc.make_staging_allocator("cpu"))):
        addr = alloc.allocate_node(1000)
        view = alloc.view(addr, 1000)
        out[pkg] = (addr % 4096, bytes(view[:8]), bytes(view[992:1000]),
                    alloc.memory_type.name, alloc.live_allocations)
        view[:4] = b"tpu!"
        alloc.deallocate_node(addr, 1000)
        out[pkg] += (alloc.live_allocations,)
    assert out["port"] == out["tpulab"] == (0, b"\0" * 8, b"\0" * 8,
                                            "host_pinned", 1, 0)
    port = tc.make_staging_allocator("cpu")
    a = port.allocate_node(100, alignment=1 << 16)
    assert a % (1 << 16) == 0
    assert port._registered == set()         # the CPU: nothing page-locked
    port.deallocate_node(a, 100)


def test_default_device_is_the_card():
    """No device means the CUDA card: without one, every entry point of
    the layer raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for fn in (tc.make_staging_allocator, tc.make_cuda_allocator,
               lambda: Buffers(1024), DeviceInfo.device_kind,
               DeviceInfo.memory_info):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_copies():
    host = torch.arange(128, dtype=torch.float32)
    dev = tc.copy_to_device(host, "cpu")
    back = tc.copy_to_host(dev)
    assert torch.equal(back, host) and back.data_ptr() != dev.data_ptr()
    out = torch.empty_like(host)
    assert tc.copy_to_host(dev, out) is out and torch.equal(out, host)
    assert torch.equal(tc.copy_device_to_device(dev, "cpu"), host)
    # tpulab's roundtrip on the same values
    jback = jt.copy_to_host(jt.copy_to_device(host.numpy()))
    np.testing.assert_array_equal(jback, back.numpy())
    from tpulab_torch.cuda import transfer
    assert transfer.copy_to_device is tc.copy_to_device   # re-exported


def test_sync_policies():
    import asyncio
    x = torch.ones(4)
    assert tc.cuda_sync_standard(x) is x
    assert tc.CudaSync.standard({"a": x})["a"] is x
    assert asyncio.run(tc.cuda_sync_async({"a": x}))["a"] is x
    assert asyncio.run(tc.CudaSync.userspace(x)) is x


def test_platform_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert tc.device_count() == 0 and tc.devices() == ()
    assert tc.platform_name() == "cpu" and not tc.is_cuda()
    with pytest.raises(IndexError):
        tc.local_device(0)


def test_device_info_on_the_host():
    """``"cpu"`` answers as tpulab's CPU backend does."""
    assert DeviceInfo.alignment() == 256
    assert DeviceInfo.device_kind("cpu") == "cpu"
    info = DeviceInfo.memory_info("cpu")
    assert (info.bytes_in_use, info.bytes_limit,
            info.peak_bytes_in_use) == (None, None, None)
    assert DeviceInfo.peak_flops("bf16", "cpu") is None
    assert jt.DeviceInfo.peak_flops("bf16") is None          # tpulab, CPU
    assert DeviceInfo.coords("cpu") is None
    assert DeviceInfo.core_on_chip("cpu") is None
    attrs = DeviceInfo.attributes("cpu")
    assert attrs["platform"] == "cpu" and "id" in attrs
    cpus = DeviceInfo.cpu_affinity("cpu")
    assert len(cpus) >= 1 and set(cpus) <= set(range(256 * 1024))


def test_peak_flops_table(monkeypatch):
    """The table carries the H100 SXM5 only (dense datasheet rates); any
    other name is unknown (None), as tpulab answers for unknown kinds."""
    for kind, want in (("NVIDIA H100 80GB HBM3", (989.4e12, 1978.9e12)),
                       ("NVIDIA A100-SXM4-80GB", (None, None)),
                       ("NVIDIA H100 PCIe", (None, None))):
        monkeypatch.setattr(DeviceInfo, "device_kind",
                            staticmethod(lambda index=0, k=kind: k))
        assert (DeviceInfo.peak_flops("bf16"),
                DeviceInfo.peak_flops("int8")) == want, kind
        if want[0]:
            assert DeviceInfo.peak_flops("fp8") == want[0]   # tpulab's rule
    markers = [m for m, _ in DeviceInfo._PEAK_FLOPS]
    assert markers == ["H100 80GB HBM3"]


def _carves(buffers, views):
    """Offsets of each carve from its block's base, the stack's depth."""
    stack = buffers._stack
    return [v % 4096 for v in views], stack.depth


@pytest.mark.parametrize("n_views", [2, 3])
def test_buffers_push_a_block_like_tpulab(n_views):
    """``Buffers(1024)`` gives 800-byte views from as many blocks as
    tpulab's ``Buffers`` does; ``reset()`` returns them, ``release()``
    frees them; a view past the block size raises tpulab's error."""
    ours, theirs = Buffers(1024, device="cpu"), JaxBuffers(1024)
    assert ours._arena.next_block_size == 1024
    got = [ours._carve(800) for _ in range(n_views)]
    want = [theirs._carve(800) for _ in range(n_views)]
    assert [t.numel() for t in got] == [a.size for a in want] == [800] * n_views
    got_addrs = [t.data_ptr() for t in got]
    assert (_carves(ours, got_addrs)
            == _carves(theirs, [a.ctypes.data for a in want])
            == ([0] * n_views, n_views))
    for i, t in enumerate(got):
        t.fill_(i + 1)                            # views do not overlap
    assert [int(t.sum()) for t in got] == [800 * (i + 1) for i in range(n_views)]
    for b in (ours, theirs):
        with pytest.raises(Exception) as e:
            b._carve(2000)
        assert type(e.value).__name__ == "OutOfMemory"
    for b in (ours, theirs):
        b.reset()
    assert ours._stack.depth == theirs._stack.depth == 0
    assert ours._arena.cached_blocks == theirs._arena.cached_blocks == n_views
    again = ours._carve(800).data_ptr()
    assert again in got_addrs                    # a cached block, reused
    raw = ours._arena._inner.raw_allocator
    ours.release()
    theirs.release()
    assert raw.live_allocations == 0 and ours._arena.cached_blocks == 0


def test_buffers_views_share_bytes_with_numpy():
    buffers = Buffers(4096, device="cpu", block_size=1024)
    t = buffers._carve(256)
    arr = t.numpy()
    arr[:] = 7
    assert int(t.sum()) == 7 * 256
    assert np.frombuffer(host_view(t.data_ptr(), 256), np.uint8).sum() == \
        7 * 256
    with pytest.raises(NotImplementedError, match="coalesce_h2d"):
        Buffers(1024, device="cpu", coalesce_h2d=True)
    buffers.release()

