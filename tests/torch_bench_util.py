"""Shared helpers of ``tests/test_torch_bench_rows*.py``.

A bench row submits each burst of requests from the calling thread while
the batcher's scheduler thread runs; whether the scheduler's pass lands
between two submits of one burst (so that the lanes start a round apart)
is thread timing, in tpulab as in the port.  :func:`settled_schedulers`
makes it deterministic in both: a scheduler thread woken from its idle
wait lets :data:`SETTLE_S` pass, without its lock, before it takes its
pass, so a burst submitted back to back is queued whole by then.
:func:`head_first_bursts` makes the other order deterministic: the
burst's first request decodes before the rest are queued.  The
rows' code and the batchers' scheduling are otherwise untouched.
"""

import contextlib
import threading
import time
import types

import jax
import numpy as np
import pytest

from tpulab.models.transformer import init_transformer_params as jax_init
from tpulab_torch.models.convert import tree_from_numpy

SETTLE_S = 0.05


class _SettlingCondition(threading.Condition):
    def wait(self, timeout=None):
        woken = super().wait(timeout)
        if threading.current_thread().name == "cbatch":
            self.release()
            try:
                time.sleep(SETTLE_S)
            finally:
                self.acquire()
        return woken


@contextlib.contextmanager
def settled_schedulers(*modules):
    """Batchers built inside the block, in each of ``modules`` (tpulab's and
    the port's ``engine.paged``), settle after each wake-up."""
    proxy = types.SimpleNamespace(**vars(threading))
    proxy.Condition = _SettlingCondition
    with pytest.MonkeyPatch.context() as mp:
        for m in modules:
            mp.setattr(m, "threading", proxy)
        yield


@contextlib.contextmanager
def head_first_bursts(lanes, *modules):
    """The card's timing at full width, made deterministic: the first
    request of each burst of ``lanes`` submits (a row's warm and timed
    bursts) gets its first decode dispatch before ``submit`` returns, so
    the rest of the burst queues behind a lane already decoding.  On the
    card the scheduler thread's eager prefill launches hold the host while
    the caller submits; here ``submit`` waits on the batcher's
    ``decode_dispatches``."""
    with pytest.MonkeyPatch.context() as mp:
        for m in modules:
            real = m.ContinuousBatcher.submit
            calls = [0]

            def submit(self, *a, _real=real, _calls=calls, **kw):
                d0 = self.decode_dispatches
                fut = _real(self, *a, **kw)
                _calls[0] += 1
                if _calls[0] % lanes == 1:
                    deadline = time.monotonic() + 60
                    while (self.decode_dispatches == d0
                           and time.monotonic() < deadline):
                        time.sleep(0.0005)
                return fut
            mp.setattr(m.ContinuousBatcher, "submit", submit)
        yield


def port_tree(**init):
    """tpulab's draw of a row's weights as the port's tree."""
    return tree_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_init(**init)), "cpu")


def key_paths(d, prefix=""):
    """Every key path of a nested dict (list values are leaves)."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= key_paths(v, prefix + k + "/")
    return out


def positive_float(x):
    return isinstance(x, float) and x > 0
