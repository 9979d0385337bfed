"""tpulab's example ladder on the port: one module per script of
``examples/`` (and ``notebooks/`` as :mod:`tpulab_torch.examples.notebooks`),
each run with ``python -m tpulab_torch.examples.<name>``.  Python cannot
import a name that starts with a digit, so ``07_llm_server.py`` is
``ex07_llm_server``; ``README.md`` maps every module to its twin.  Each
keeps its twin's flags, defaults and printed lines, except that ``--cpu``
becomes ``--device cpu``: like every entry point of the port, an example
runs on the CUDA card unless asked otherwise."""
