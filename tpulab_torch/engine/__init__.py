"""Serving engines of the port: the paged KV pool, paged programs and
``ContinuousBatcher`` (``paged``); the compiled-model path (``model``,
``runtime``, ``execution_context``, ``buffers``, ``inference_manager``,
``infer_runner``, ``batched_runner``, ``infer_bench``)."""
