"""Device layer of the port: CUDA platform handles, tracked allocators,
event sync and side-stream transfers."""
