"""Host utilities of the port (own copies of tpulab.core pieces: deadlines,
pools, thread pools, the deferred task pool, packaged tasks)."""
