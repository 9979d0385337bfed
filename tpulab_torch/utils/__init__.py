"""Auxiliary subsystems of the port (``tpulab/utils``): request tracing
(``tracing``), Prometheus metrics without prometheus_client
(``metrics``) and the device watchdog (``watchdog``)."""
