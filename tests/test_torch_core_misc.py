"""The port's small core surfaces held against tpulab's: thread-type
policies and the event-loop group (``core/threads.py``), DLPack dtypes
(``core/dtypes.py``), the alignment literals (``memory/literals.py``)
and ``tpulab_torch.core``'s public names."""

import asyncio

import numpy as np
import pytest

import tpulab.core as jcore
import tpulab_torch.core as tcore
from tpulab.core import dtypes as jd
from tpulab.memory import literals as jl
from tpulab_torch.core import dtypes as td
from tpulab_torch.memory import literals as tl

PKGS = {"tpulab": (jcore, jd, jl), "port": (tcore, td, tl)}


@pytest.mark.parametrize("pkg", ["tpulab", "port"])
def test_standard_threads_policy(pkg):
    core = PKGS[pkg][0]
    st = core.standard_threads
    assert st.async_(lambda a, b: a + b, 2, 3).result(timeout=5) == 5
    boom = st.async_(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        boom.result(timeout=5)
    with st.Mutex():
        pass
    with st.RecursiveMutex():
        pass
    assert st.make_future() is not None and st.Future is not None
    st.sleep(0.001)


@pytest.mark.parametrize("pkg", ["tpulab", "port"])
def test_userspace_threads_policy(pkg):
    us = PKGS[pkg][0].userspace_threads

    async def scenario():
        fut = us.make_future()
        task = us.async_(us.sleep(0.01))
        await task
        fut.set_result(7)
        async with us.Mutex():
            pass
        return await fut

    assert asyncio.run(scenario()) == 7


@pytest.mark.parametrize("pkg", ["tpulab", "port"])
def test_event_loop_group(pkg):
    elg_cls = PKGS[pkg][0].EventLoopGroup
    with pytest.raises(ValueError):
        elg_cls(0)
    with elg_cls(3, name="t") as elg:
        assert elg.size == 3

        async def double(x):
            await asyncio.sleep(0)
            return 2 * x

        futs = [elg.submit(double(i)) for i in range(9)]
        assert [f.result(timeout=5) for f in futs] == [2 * i for i in range(9)]
        assert elg.submit_fn(lambda a: a + 1, 41).result(timeout=5) == 42


def _dtype_trace(d):
    out = []
    for name in ("int8", "int16", "int32", "int64", "uint8", "uint16",
                 "uint32", "uint64", "float16", "float32", "float64",
                 "bfloat16"):
        t = getattr(d, name)
        out.append((name, int(t.code), t.bits, t.lanes, t.itemsize, str(t)))
        for other in (np.float32, np.int32, np.uint8, np.float16):
            out.append(t.is_compatible(other))
        if name != "bfloat16":
            out.append(t.to_numpy().name)
    vec = d.DType(d.DLDataTypeCode.kDLFloat, 32, lanes=4)
    out += [vec.itemsize, str(vec)]
    for np_dt in (np.float16, np.float32, np.float64, np.int8, np.int16,
                  np.int32, np.int64, np.uint8, np.uint16, np.uint32,
                  np.uint64):
        out.append(str(d.dtype_from_numpy(np_dt)))
    for bad in (np.complex64, np.bool_):
        with pytest.raises(TypeError):
            d.dtype_from_numpy(bad)
    with pytest.raises(TypeError):
        d.DType(d.DLDataTypeCode.kDLFloat, 8).to_numpy()
    out.append(sorted((c.name, int(c)) for c in d.DLDataTypeCode))
    return out


def test_dtypes_match_tpulab():
    """Every answer of tpulab's dtype table, but bfloat16's numpy dtype
    (tpulab's comes from ml_dtypes, which the port does not load)."""
    assert _dtype_trace(td) == _dtype_trace(jd)
    assert td.float32.to_numpy() == np.dtype(np.float32)
    assert td.dtype_from_numpy(np.uint16) is td.uint16


def test_bfloat16_has_no_numpy_dtype_in_the_port():
    """tpulab returns ml_dtypes' bfloat16; the port raises, and still
    recognises that dtype when it is handed one (by name)."""
    ml_bf16 = jd.bfloat16.to_numpy()
    assert ml_bf16.name == "bfloat16"
    with pytest.raises(TypeError, match="no numpy equivalent"):
        td.bfloat16.to_numpy()
    assert td.dtype_from_numpy(ml_bf16) is td.bfloat16
    assert td.bfloat16.is_compatible(ml_bf16) and jd.bfloat16.is_compatible(
        ml_bf16)
    assert not td.bfloat16.is_compatible(np.float16)


@pytest.mark.parametrize("pkg", ["tpulab", "port"])
def test_align_helpers(pkg):
    lit = PKGS[pkg][2]
    assert lit.align_up(100, 64) == 128 and lit.align_down(100, 64) == 64
    assert lit.is_aligned(128, 64) and not lit.is_aligned(100, 64)
    assert lit.ilog2(1024) == 10 and lit.ilog2(1) == 0
    with pytest.raises(ValueError):
        lit.align_up(1, 3)
    with pytest.raises(ValueError):
        lit.align_down(1, 0)
    with pytest.raises(ValueError):
        lit.ilog2(0)


def test_literals_match_tpulab():
    vals = [(0, 1), (1, 8), (7, 8), (8, 8), (4095, 4096), (4097, 4096),
            (1 << 40, 256)]
    for v, a in vals:
        assert tl.align_up(v, a) == jl.align_up(v, a)
        assert tl.align_down(v, a) == jl.align_down(v, a)
        assert tl.is_aligned(v, a) == jl.is_aligned(v, a)
    assert [tl.ilog2(n) for n in (1, 2, 3, 1 << 33)] == [
        jl.ilog2(n) for n in (1, 2, 3, 1 << 33)]


def test_core_public_surface_matches_tpulab():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert getattr(tcore, name).__name__ == getattr(jcore, name).__name__


@pytest.mark.parametrize("pkg", ["tpulab", "port"])
def test_unique_pool_and_affinity(pkg):
    core = PKGS[pkg][0]
    pool = core.UniquePool([1, 2])
    with pool.pop_unique() as v:
        assert v in (1, 2) and pool.available == 1
    assert pool.available == 2
    cpus = core.Affinity.get_affinity()
    assert len(cpus) >= 1
    s = core.CpuSet.from_string("0-3,8,10-11")
    assert list(s) == [0, 1, 2, 3, 8, 10, 11]
    assert list(s & core.CpuSet([2, 8, 9])) == [2, 8]
    assert list(s - core.CpuSet(range(4))) == [8, 10, 11]
    assert core.Affinity.round_robin(3, core.CpuSet([5])) == [5, 5, 5]
