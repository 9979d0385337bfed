"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \
         -o <lib>.so csrc/<name>.cu

``--split-compile=0`` runs the device compiler's optimization passes on
every CPU of the host: the kernels' dtype and head-dim instantiations
built in about half the time (175 of them in 40.2 s against 76.8 s on
an H100's host, ``tools/kernel_ab.py``).  With D 16 on all three
kernels and D 32 on the paged one, ``nvcc -Xptxas -v`` reports 259
(ragged 79, flash 15, paged 165), built in 42.6-50.2 s wall on an
H100's host (``chip_smoke.py``, the paged library the longest).

The library lands in ``build/tpulab_torch/`` at the repository root (git
ignores it), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one loads as it is.  Nothing is built
when a module is imported: only a kernel launch on a CUDA tensor (or
``chip_smoke.py``) calls :func:`load`; the kernel's own module declares
its C functions' types.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpulab_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--split-compile=0")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def compile_library(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing.
    Returns ``(path, seconds, log)``.  Safe to run in several processes
    at once: each compiles into a private temporary file and renames it
    into place."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src.name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (if needed) and load its library."""
    return ctypes.CDLL(str(compile_library(name)[0]))
