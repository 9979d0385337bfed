"""End-to-end request deadlines (monotonic-clock budgets).

The port's own copy of ``tpulab/core/deadline.py`` (tpulab_torch imports
nothing of tpulab); the semantics are identical.

A client's deadline must survive every hop — router pick, RPC transport,
batcher queue, engine step — or slow replicas silently convert "answer in
200 ms" into "hold a lane for 300 s".  This module is the one shared
currency: a :class:`Deadline` wraps an absolute ``time.monotonic`` expiry
and every layer (ReplicaSet attempt budgets, the Generate RPC, the
continuous batcher's tick sweep, dense session streaming) checks the SAME
object semantics.  Cross-process propagation sends the *remaining budget*
(``GenerateRequest.deadline_ms``), never a wall-clock timestamp — replica
clocks need not agree.
"""

from __future__ import annotations

import time
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end deadline expired.

    A ``TimeoutError`` subclass so generic timeout handling still works,
    but distinct so routers can tell "this request's global budget is
    spent — stop" from "this attempt stalled — fail over".
    """


class Deadline:
    """Absolute monotonic expiry; ``None`` seconds = no deadline.

    Cheap by design — one float — because a Deadline rides every request.
    """

    __slots__ = ("expiry",)

    def __init__(self, expiry: Optional[float]):
        self.expiry = expiry

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        """Deadline ``seconds`` from now (``None`` -> unbounded)."""
        if seconds is None:
            return cls(None)
        return cls(time.monotonic() + max(0.0, float(seconds)))

    def remaining(self) -> Optional[float]:
        """Seconds left (clamped at 0), or None when unbounded."""
        if self.expiry is None:
            return None
        return max(0.0, self.expiry - time.monotonic())

    def expired(self) -> bool:
        return self.expiry is not None and time.monotonic() >= self.expiry

    def check(self, what: str = "request") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} deadline exceeded")

    def per_attempt(self, attempts_left: int,
                    floor: float = 0.05) -> Optional[float]:
        """Budget for one of ``attempts_left`` remaining tries: an even
        split of what's left, floored so a nearly-spent deadline still
        issues a real attempt instead of a 0-second farce (the final
        expiry check, not the floor, is what enforces the deadline)."""
        rem = self.remaining()
        if rem is None:
            return None
        return max(floor, rem / max(1, attempts_left))

    def bound(self, timeout: Optional[float]) -> Optional[float]:
        """``min(timeout, remaining)`` treating None as unbounded."""
        rem = self.remaining()
        if rem is None:
            return timeout
        if timeout is None:
            return rem
        return min(timeout, rem)

    def __repr__(self) -> str:
        rem = self.remaining()
        return ("Deadline(unbounded)" if rem is None
                else f"Deadline(remaining={rem:.3f}s)")
