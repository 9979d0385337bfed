"""Device layer of the port: CUDA platform handles and the tracked allocator."""
