"""Promise-fulfilling callable wrappers (the port's own copy of
``tpulab/core/async_compute.py``).

``async_compute(fn)`` returns a :class:`SharedPackagedTask`: a callable
whose invocation runs ``fn`` and settles a shared future with its result
or its exception — the glue between the infer pipeline's stages.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Generic, TypeVar

R = TypeVar("R")


class SharedPackagedTask(Generic[R]):
    """Callable binding a user function to a promise."""

    def __init__(self, fn: Callable[..., R]):
        self._fn = fn
        self._future: Future = Future()

    def get_future(self) -> Future:
        return self._future

    def __call__(self, *args, **kwargs) -> None:
        if self._future.done():
            raise RuntimeError("SharedPackagedTask already invoked")
        try:
            self._future.set_result(self._fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - promise semantics
            self._future.set_exception(e)


def async_compute(fn: Callable[..., R]) -> SharedPackagedTask[R]:
    """Wrap ``fn`` into a :class:`SharedPackagedTask`."""
    return SharedPackagedTask(fn)
