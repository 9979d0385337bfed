"""Program scratch measurement (the third HBM tenant; the port of
``tpulab/hbm/scratch.py``).

A serving program allocates temporaries that neither the KV pool nor the
weight multiplexer ever sees (activations, the f32 copy of the
``lm_head`` each forward makes, attention split partials).  This module
makes them a ledger tenant: :class:`MeasuredJit` wraps one of the
batcher's programs and, once per distinct shape key, records the bytes
that call needed beyond what it left allocated, with the arbiter under
``("scratch", (name, shape-key))``.

tpulab reads XLA's compile-time ``temp_size_in_bytes``.  Eager PyTorch
has no compile step, so the measurement here is taken at run time, on
the key's FIRST call: the device is synchronized, the CUDA caching
allocator's peak statistic is reset, the program runs, the device is
synchronized again, and the claim is the peak of allocated bytes over
the call minus the bytes still allocated after it (the outputs, which
the caller owns).  Its limits:

- the statistic is process-wide: another thread allocating on the same
  device during the call (an Infer context, the transfer collector)
  inflates the peak.  Measure on the scheduler thread, and read a claim
  as "this program needs at least about this much", never as tpulab's
  compile-time figure (the two are not comparable: XLA fuses casts that
  eager PyTorch materializes);
- the first call pays two device synchronizations (every later call of
  the key pays a dictionary lookup);
- the caching allocator rounds blocks up, so small programs read a few
  KiB high; what it keeps RESERVED is not counted at all;
- on the CPU there is no allocator statistic and the claim is 0 bytes,
  as ``CompiledModel.activation_size_in_bytes`` reports 0 there — and a
  0-byte claim leaves no ledger entry (the ledger's ``resize`` drops
  zero claims); the key is still recorded in :attr:`MeasuredJit.keys`.

Measuring is armed only when an :class:`~tpulab_torch.hbm.HBMArbiter`
with ``measure_scratch=True`` is attached to the engine; unarbitrated
engines call their programs directly and pay nothing.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

log = logging.getLogger("tpulab_torch.hbm")

__all__ = ["MeasuredJit", "shape_key"]


def _leaf_key(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return tuple((k, _leaf_key(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(_leaf_key(v) for v in x)
    return repr(x)


def shape_key(args: Sequence[Any], kwargs: Dict[str, Any],
              skip: Sequence[int] = ()) -> Tuple:
    """Hashable signature of a program call: per tensor (shape, dtype),
    the ``repr`` of anything else (None, ints, K), keyword arguments by
    name; positional arguments in ``skip`` are left out."""
    pos = tuple(_leaf_key(a) for i, a in enumerate(args) if i not in skip)
    return pos + tuple((k, _leaf_key(v)) for k, v in sorted(kwargs.items()))


def _device_of(args: Sequence[Any]):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class MeasuredJit:
    """A program that records its scratch with an
    :class:`~tpulab_torch.hbm.HBMArbiter` once per shape key (module
    docstring); tpulab's name, kept so a reader finds the counterpart.

    ``skip`` lists positional arguments the key leaves out: the batcher
    passes its weights (fixed for its life) and its page store (written in
    place through page tables, so its page count sizes no temporary —
    a pool grow or shrink adds no claim).  The call itself always runs
    the plain program with the same arguments: measuring never changes
    what it computes."""

    __slots__ = ("_fn", "_arbiter", "_name", "_skip", "keys")

    def __init__(self, fn: Callable, arbiter, name: str,
                 skip: Sequence[int] = ()):
        self._fn = fn
        self._arbiter = arbiter
        self._name = name
        self._skip = tuple(skip)
        #: shape key -> bytes recorded (one entry per key seen)
        self.keys: Dict[Tuple, int] = {}

    def __call__(self, *args, **kwargs):
        key = shape_key(args, kwargs, self._skip)
        if key in self.keys:
            return self._fn(*args, **kwargs)
        dev = _device_of(args)
        if dev is None or dev.type != "cuda":
            out = self._fn(*args, **kwargs)
            nbytes = 0
        else:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = self._fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            nbytes = max(0, torch.cuda.max_memory_allocated(dev)
                         - max(base, torch.cuda.memory_allocated(dev)))
        self.keys[key] = nbytes
        log.debug("scratch %s %r: %d bytes", self._name, key, nbytes)
        self._arbiter.record_scratch((self._name, key), nbytes)
        return out
