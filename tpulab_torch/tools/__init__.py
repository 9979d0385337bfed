"""Command-line tools of the port (``python -m tpulab_torch.tools.<name>``):
:mod:`onnx_summary` (the ONNX import preflight) and :mod:`build_engine`
(build an engine artifact ahead of serving)."""
