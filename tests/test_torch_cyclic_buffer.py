"""The cyclic windowed buffers held against tpulab's: the host stacks of
``core/cyclic_buffer.py`` on tpulab's eight cases, the device stack
(``CudaCyclicWindowedStack`` on ``device="cpu"``) against
``TpuCyclicWindowedStack`` window by window, and a streamed window NLL
through tpulab's small transformer and the port's on the same weights."""

import threading
import time
from concurrent.futures import Future
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulab.core as jcore
import tpulab.memory as jm
import tpulab_torch.core as tcore
import tpulab_torch.memory as tm
from tpulab.models.transformer import init_transformer_params as j_init
from tpulab.models.transformer import transformer_apply as j_apply
from tpulab.tpu.cyclic_buffer import TpuCyclicWindowedStack
from tpulab_torch.cuda.cyclic_buffer import CudaCyclicWindowedStack
from tpulab_torch.models.convert import tree_from_numpy
from tpulab_torch.models.transformer import transformer_apply as t_apply

PKGS = {"tpulab": (jcore, jm), "port": (tcore, tm)}
both = pytest.mark.parametrize("pkg", ["tpulab", "port"])


def make_buffer(pkg, size):
    mem = PKGS[pkg][1]
    return mem.make_allocator(mem.MallocAllocator()).allocate_descriptor(size)


@both
def test_geometry_validation(pkg):
    stack = PKGS[pkg][0].CyclicWindowedStack
    buf = make_buffer(pkg, 64)
    with pytest.raises(ValueError):
        stack(buf, window_count=4, window_size=8, overlap=8)
    with pytest.raises(ValueError):
        stack(buf, window_count=100, window_size=8)
    with pytest.raises(ValueError):
        stack(buf, window_count=1, window_size=8, overlap=2)
    buf.release()


@both
def test_windows_fire_in_order(pkg):
    seen = []
    buf = make_buffer(pkg, 1024)
    stack = PKGS[pkg][0].CyclicWindowedStack(
        buf, window_count=4, window_size=16, overlap=0,
        on_window=lambda wid, view: seen.append((wid, bytes(view[:2]))) or None)
    stack.append(bytes(range(64)))
    assert [wid for wid, _ in seen] == [0, 1, 2, 3]
    assert seen[0][1] == b"\x00\x01" and seen[1][1] == b"\x10\x11"
    assert stack.current_window == 4 and stack.bytes_in_current_window == 0
    stack.release()


@both
def test_overlap_carries_context(pkg):
    windows = []
    buf = make_buffer(pkg, 1024)
    stack = PKGS[pkg][0].CyclicWindowedStack(
        buf, window_count=3, window_size=8, overlap=4,
        on_window=lambda wid, view: windows.append(bytes(view)) or None)
    data = bytes(range(40))
    stack.append(data)
    for i in range(1, len(windows)):
        assert windows[i][:4] == windows[i - 1][4:]
    for i, w in enumerate(windows):
        assert w == data[i * 4:i * 4 + 8]
    stack.release()


@both
def test_wraparound_replication(pkg):
    windows = []
    buf = make_buffer(pkg, 3 * 4 + 4)          # exactly count*stride+overlap
    stack = PKGS[pkg][0].CyclicWindowedStack(
        buf, window_count=3, window_size=8, overlap=4,
        on_window=lambda wid, view: windows.append(bytes(view)) or None)
    data = bytes(range(60))
    stack.append(data)
    for i, w in enumerate(windows):
        assert w == data[i * 4:i * 4 + 8], f"window {i} wrong after wrap"
    assert len(windows) >= 10
    stack.release()


@both
def test_backpressure_blocks_on_inflight_window(pkg):
    buf = make_buffer(pkg, 64)
    gate = Future()

    def on_window(wid, view):
        return gate if wid == 0 else None

    stack = PKGS[pkg][0].CyclicWindowedStack(buf, window_count=2,
                                             window_size=16, overlap=0,
                                             on_window=on_window)
    stack.append(bytes(32))                      # windows 0, 1; 0 in flight
    done = threading.Event()

    def writer():
        stack.append(bytes(16))                  # reuses slot 0: blocks
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    time.sleep(0.05)
    assert not done.is_set()
    gate.set_result(None)
    assert done.wait(timeout=2)
    t.join()
    stack.release()


@both
def test_task_executor_records_sync(pkg):
    core = PKGS[pkg][0]
    results = []
    buf = make_buffer(pkg, 1024)
    with core.ThreadPool(2) as tp:
        ex = core.CyclicWindowedTaskExecutor(
            buf, window_count=4, window_size=16, overlap=0,
            compute_fn=lambda wid, view: results.append((wid, view[0])),
            executor=tp)
        ex.append(bytes([7] * 64))
        ex.sync_all()
    assert sorted(w for w, _ in results) == [0, 1, 2, 3]
    assert all(v == 7 for _, v in results)
    ex.release()


@both
def test_reserved_stack_zero_copy_fill(pkg):
    core = PKGS[pkg][0]
    buf = make_buffer(pkg, 1024)
    stack = core.CyclicWindowedReservedStack(buf, window_count=2,
                                             window_size=16)
    wid, view = stack.reserve_window()
    assert wid == 0
    view[:] = bytes([9] * 16)
    with pytest.raises(RuntimeError):
        stack.reserve_window()
    stack.release_window()
    with pytest.raises(RuntimeError):
        stack.release_window()
    wid2, _ = stack.reserve_window()
    assert wid2 == 1
    stack.release_window()
    wid3, view3 = stack.reserve_window()
    assert wid3 == 2 and bytes(view3) == bytes([9] * 16)
    stack.release_window()
    stack.release()


@both
def test_compute_error_propagates_on_reuse(pkg):
    buf = make_buffer(pkg, 64)

    def failing(wid, view):
        f = Future()
        f.set_exception(RuntimeError("window compute failed"))
        return f

    stack = PKGS[pkg][0].CyclicWindowedStack(buf, window_count=2,
                                             window_size=16, overlap=0,
                                             on_window=failing)
    with pytest.raises(RuntimeError, match="window compute failed"):
        stack.append(bytes(48))
    stack._sync = [None] * 2
    stack.release()


def _device_windows(stack_cls, conv, data, count, size, overlap, executor):
    """(window id, bytes the compute saw) for every window of ``data``."""
    seen = []
    buf = make_buffer("tpulab" if stack_cls is TpuCyclicWindowedStack
                      else "port", count * (size - overlap) + overlap)
    kw = dict(device="cpu") if stack_cls is CudaCyclicWindowedStack else {}

    def compute(wid, dev):
        seen.append((wid, conv(dev)))
        return dev

    stack = stack_cls(buf, window_count=count, window_size=size,
                      overlap=overlap, compute_fn=compute, executor=executor,
                      **kw)
    for i in range(0, len(data), 7):            # ragged appends
        stack.append(data[i:i + 7])
    stack.sync_all()
    stack.release()
    return sorted(seen)


@pytest.mark.parametrize("overlap", [0, 16])
@pytest.mark.parametrize("threads", [0, 2])
def test_device_stack_matches_tpulab(overlap, threads):
    """The same window ids and bytes through the port's device stack (on
    the CPU) as through tpulab's, with and without an executor."""
    data = bytes(np.random.default_rng(3).integers(0, 256, 700,
                                                   dtype=np.uint8))
    args = (data, 4, 64, overlap)
    with jcore.ThreadPool(max(threads, 1)) as jp, \
            tcore.ThreadPool(max(threads, 1)) as tp:
        want = _device_windows(TpuCyclicWindowedStack,
                               lambda d: np.asarray(d).tobytes(), *args,
                               jp if threads else None)
        got = _device_windows(CudaCyclicWindowedStack,
                              lambda d: d.numpy().tobytes(), *args,
                              tp if threads else None)
    assert got == want and len(got) >= 10
    stride = 64 - overlap
    for wid, b in got:
        assert b == data[wid * stride:wid * stride + 64]


def test_device_stack_hands_compute_its_own_copy():
    """The window tensor is a copy: rewriting the slot later leaves a
    tensor the compute kept unchanged."""
    kept = {}
    buf = make_buffer("port", 2 * 32)
    stack = CudaCyclicWindowedStack(buf, window_count=2, window_size=32,
                                    device="cpu", dtype=torch.int32,
                                    compute_fn=lambda w, d: kept.setdefault(w, d))
    stack.append(np.arange(48, dtype=np.int32).tobytes())
    assert sorted(kept) == list(range(6))
    assert kept[0].tolist() == list(range(8))
    assert kept[2].tolist() == list(range(16, 24))   # slot 0 rewritten
    stack.release()


VOCAB, D, HEADS, LAYERS, DFF = 97, 64, 4, 2, 128
WINDOW, OVERLAP, COUNT = 32, 8, 3


def _nll_np(logits, tokens):
    logp = logits[OVERLAP - 1:-1].astype(np.float64)
    nxt = tokens[OVERLAP:]
    lse = np.log(np.exp(logp - logp.max(-1, keepdims=True)).sum(-1)) \
        + logp.max(-1)
    return float((lse - logp[np.arange(len(nxt)), nxt]).mean())


def test_streamed_window_nll_matches_tpulab():
    """examples/04_long_context_stream.py's scoring: each window's
    continuation NLL through tpulab's small transformer (tpulab's device
    stack) and the port's (the port's device stack, on the CPU), on the
    weights bridged by ``models/convert.py``; f32 within 1e-4."""
    jp = j_init(VOCAB, D, HEADS, LAYERS, DFF, seed=5)
    tp = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jfwd = jax.jit(partial(j_apply, n_heads=HEADS, n_layers=LAYERS,
                           compute_dtype=jnp.float32))
    tokens = np.random.default_rng(11).integers(0, VOCAB, 200, dtype=np.int32)
    tb = 4                                      # int32 bytes
    size = COUNT * (WINDOW - OVERLAP) * tb + OVERLAP * tb
    want, got = {}, {}

    def j_compute(wid, dev):
        toks = np.asarray(dev)
        want[wid] = _nll_np(np.asarray(jfwd(jp, {"tokens": dev[None]})[
            "logits"][0]), toks)
        return dev

    def t_compute(wid, dev):
        with torch.inference_mode():
            logits = t_apply(tp, {"tokens": dev[None].long()},
                             n_heads=HEADS, n_layers=LAYERS,
                             compute_dtype=torch.float32)["logits"][0]
        got[wid] = _nll_np(logits.numpy(), dev.numpy())
        return dev

    for cls, compute, mem, extra in (
            (TpuCyclicWindowedStack, j_compute, jm, dict(dtype=np.int32)),
            (CudaCyclicWindowedStack, t_compute, tm,
             dict(dtype=torch.int32, device="cpu"))):
        buf = mem.make_allocator(mem.MallocAllocator()).allocate_descriptor(
            size)
        stack = cls(buf, window_count=COUNT, window_size=WINDOW * tb,
                    overlap=OVERLAP * tb, compute_fn=compute, **extra)
        for i in range(0, len(tokens), 24):
            stack.append(tokens[i:i + 24].tobytes())
        stack.sync_all()
        stack.release()
    n_win = (len(tokens) - OVERLAP) // (WINDOW - OVERLAP)
    assert sorted(got) == sorted(want) == list(range(n_win))
    for w in range(n_win):
        assert got[w] == pytest.approx(want[w], rel=1e-4), w
