"""Shared helpers of ``tests/test_torch_bench_rows*.py``.

A bench row submits each burst of requests from the calling thread while
the batcher's scheduler thread runs; whether the scheduler's pass lands
between two submits of one burst (so that the lanes start a round apart),
or before or after a burst sent on a streamed token, is thread timing,
in tpulab as in the port.  :func:`settled_schedulers` makes it
deterministic in both, without a clock: the threads that submit run in
lockstep with the schedulers.  Such a client thread runs from its first
``submit`` until it waits (on a future's result, an event, a semaphore:
every such wait is a ``threading.Condition`` wait; or a thread join),
and runs again from the moment it is notified; a scheduler takes no pass
(its loop's hold of its condition) while a live client runs.  So every
burst is queued whole, at the same point of the scheduler's walk, every
time.  :func:`head_first_bursts` makes another order deterministic: the
burst's first request decodes before the rest are queued.  The rows'
code and the batchers' scheduling are otherwise untouched.
"""

import contextlib
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest

from tpulab.models.transformer import init_transformer_params as jax_init
from tpulab_torch.models.convert import tree_from_numpy

#: a guard, not a setting: the longest a scheduler waits for its clients.
#: A client runs only until it next waits, so only a thread that blocks
#: some other way reaches it, and the block then fails.
CLIENT_GUARD_S = 60.0

_real_wait = threading.Condition.wait
_real_notify = threading.Condition.notify
_real_join = threading.Thread.join


class _Clients:
    """The threads that submit to a batcher (never a scheduler), each
    running or waiting, and the schedulers' gate on them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.changed = threading.Condition(self.lock)
        self.threads = {}          # ident -> Thread, every client
        self.running = {}          # ident -> Thread, clients not waiting
        self.stalls = 0

    def submits(self):
        t = threading.current_thread()
        if not t.name.startswith("cbatch"):
            with self.lock:
                self.threads[t.ident] = self.running[t.ident] = t

    def waits(self):
        with self.lock:
            self.running.pop(threading.get_ident(), None)
            self.changed.notify_all()

    def runs(self, idents):
        with self.lock:
            for i in idents:
                if i in self.threads:
                    self.running[i] = self.threads[i]

    def settle(self):
        """Return once no live client runs."""
        waited = 0.0
        with self.lock:
            while any(t.is_alive() for t in self.running.values()):
                if waited >= CLIENT_GUARD_S:
                    self.stalls += 1
                    return
                _real_wait(self.changed, 0.01)   # a dead client wakes no one
                waited += 0.01


def _in_scheduler_loop():
    """The caller of the caller is a scheduler thread's loop (the port's
    ``_loop``, tpulab's ``_run``)."""
    return (threading.current_thread().name == "cbatch"
            and sys._getframe(2).f_code.co_name in ("_loop", "_run"))


@contextlib.contextmanager
def settled_schedulers(*modules):
    """Batchers built inside the block, in each of ``modules`` (tpulab's and
    the port's ``engine.paged``), take no pass while a client runs."""
    clients = _Clients()

    class SettlingCondition(threading.Condition):
        def __enter__(self):
            if _in_scheduler_loop():
                clients.settle()
            return super().__enter__()

        def wait(self, timeout=None):
            woken = super().wait(timeout)
            if _in_scheduler_loop():
                self.release()
                try:
                    clients.settle()
                finally:
                    self.acquire()
            return woken

    def waiting(self, timeout=None):
        # every waiter in arrival order (the order notify wakes them in),
        # kept under the condition's own lock like its waiter deque
        ident = threading.get_ident()
        queue = self.__dict__.setdefault("_arrivals", [])
        queue.append(ident)
        if ident in clients.threads:
            clients.waits()
        try:
            return _real_wait(self, timeout)
        finally:
            if ident in queue:                  # timed out: not notified
                queue.remove(ident)
            clients.runs([ident])

    def notifying(self, n=1):
        queue = self.__dict__.get("_arrivals")
        if queue:
            woken, queue[:n] = queue[:n], []
            clients.runs(woken)
        return _real_notify(self, n)

    def joining(self, timeout=None):
        client = threading.get_ident() in clients.threads
        if client:
            clients.waits()
        try:
            return _real_join(self, timeout)
        finally:
            if client:
                clients.runs([threading.get_ident()])

    proxy = types.SimpleNamespace(**vars(threading))
    proxy.Condition = SettlingCondition
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(threading.Condition, "wait", waiting)
        mp.setattr(threading.Condition, "notify", notifying)
        mp.setattr(threading.Thread, "join", joining)
        for m in modules:
            mp.setattr(m, "threading", proxy)
            for name in ("submit", "submit_shipped"):
                real = getattr(m.ContinuousBatcher, name)

                def submitting(self, *a, _real=real, **kw):
                    clients.submits()
                    return _real(self, *a, **kw)
                mp.setattr(m.ContinuousBatcher, name, submitting)
        yield
    assert not clients.stalls, (
        f"{clients.stalls} scheduler passes waited {CLIENT_GUARD_S} s for "
        "a client that neither waited nor exited")


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
