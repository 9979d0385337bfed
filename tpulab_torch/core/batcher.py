"""The dynamic-batching state machine (the port's own copy of
``tpulab/core/batcher.py``; reference batcher.h:23-154).

``StandardBatcher`` is *pure state* — no threads, no locks, no timers
(exactly like the reference): ``enqueue(item)`` returns a shared future tied
to the batch the item joined; ``update()`` closes the batch when full;
``close_batch()`` closes it unconditionally (the timeout path).  All policy
(who calls close, on which thread, after what window) lives in the
:mod:`dispatcher`.

One promise per batch: every item in a batch shares the same future
(reference batcher.h:100-116).
"""

from __future__ import annotations

import itertools
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


@dataclass
class Batch(Generic[T]):
    """A closed batch: items + the promise completing them
    (reference Batcher::Batch{items, promise, batch_id})."""

    batch_id: int
    items: List[T]
    future: Future = field(default_factory=Future)

    def complete(self, result=None) -> None:
        self.future.set_result(result)

    def fail(self, exc: BaseException) -> None:
        self.future.set_exception(exc)

    def __len__(self) -> int:
        return len(self.items)


class StandardBatcher(Generic[T]):
    """Batching state machine (reference StandardBatcher<T, ThreadType>)."""

    def __init__(self, max_batch_size: int):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_batch_size = max_batch_size
        self._ids = itertools.count()
        self._open: Optional[Batch[T]] = None

    @property
    def current_batch_id(self) -> Optional[int]:
        return self._open.batch_id if self._open else None

    @property
    def current_batch_size(self) -> int:
        return len(self._open.items) if self._open else 0

    def enqueue(self, item: T) -> Future:
        """Add item to the open batch; returns that batch's shared future."""
        if self._open is None:
            self._open = Batch(next(self._ids), [])
        self._open.items.append(item)
        return self._open.future

    def update(self) -> Optional[Batch[T]]:
        """Close and return the batch iff full (reference update())."""
        if self._open is not None and len(self._open.items) >= self.max_batch_size:
            return self.close_batch()
        return None

    def close_batch(self) -> Optional[Batch[T]]:
        """Unconditionally close the open batch (timeout path)."""
        batch, self._open = self._open, None
        return batch

    def empty(self) -> bool:
        return self._open is None
