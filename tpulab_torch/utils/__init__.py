"""Auxiliary subsystems of the port (``tpulab/utils``): request tracing
(``tracing``).  tpulab's ``watchdog`` and ``metrics`` are not ported yet
(ROADMAP queue 1, item 5: observability)."""
