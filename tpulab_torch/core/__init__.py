"""Host utilities of the port (own copies of tpulab.core pieces)."""
