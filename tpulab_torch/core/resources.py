"""Service-wide resource bundle base (the port's own copy of
``tpulab/core/resources.py``; reference resources.h:33-42).

RPC contexts downcast the shared Resources object to their concrete type via
``cast()`` — the Python analog of ``casted_shared_from_this<T>()``.
"""

from __future__ import annotations

from typing import Type, TypeVar

T = TypeVar("T", bound="Resources")


class Resources:
    """Base class for bundles of pools/clients/managers shared by services."""

    def cast(self, cls: Type[T]) -> T:
        if not isinstance(self, cls):
            raise TypeError(f"resources are {type(self).__name__}, not {cls.__name__}")
        return self
