"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each library ``<name>`` is compiled by ``nvcc`` from the translation
units :data:`UNITS` lists for it, in parallel (``csrc/<name>.cu``, for
kernels 1 and 3 their padded head-dim forms in ``csrc/<name>_padded.cu``,
for kernel 1 its tensor-core body at D 144-256 in
``csrc/<name>_wgmma_256.cu``, for all three the wide fma form of every head dim past 256 in
``csrc/<name>_wide.cu``, and for kernels 1 and 2 its tensor-core twin in
``csrc/<name>_wgmma_wide.cu``), into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \
         -c -o <unit>.o csrc/<unit>.cu          # each unit, all at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib>.so *.o

``--split-compile=0`` runs the device compiler's optimization passes on
every CPU of the host: the kernels' dtype and head-dim instantiations
built in about half the time (175 of them in 40.2 s against 76.8 s on
an H100's host, ``tools/kernel_ab.py``).  With D 16 on all three
kernels and D 32 on the paged one, ``nvcc -Xptxas -v`` reports 259
(ragged 79, flash 15, paged 165), built in 42.6-50.2 s wall on an
H100's host (``chip_smoke.py``, the paged library the longest).  Every
head dim up to 256 added padded forms: as one unit each, ragged 107 and
paged 189 built in 68.3 s; as second units they build beside the
first.

The library lands in ``build/tpulab_torch/`` at the repository root (git
ignores it), named by a hash of its sources, the shared headers
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpulab_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
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


#: each library's translation units under ``csrc/``
UNITS = {
    "ragged_attention": ("ragged_attention.cu", "ragged_attention_padded.cu",
                         "ragged_attention_wgmma_256.cu",
                         "ragged_attention_wide.cu",
                         "ragged_attention_wgmma_wide.cu"),
    "flash_attention": ("flash_attention.cu", "flash_attention_wide.cu",
                        "flash_attention_wgmma_wide.cu"),
    "paged_attention": ("paged_attention.cu", "paged_attention_padded.cu",
                        "paged_attention_wide.cu"),
}


def _sources(name: str) -> list:
    """The library's translation units."""
    return [CSRC / unit for unit in UNITS[name]]


def _nvcc_run(args: list, what: str) -> str:
    proc = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {what}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return proc.stdout + proc.stderr


def compile_library(name: str) -> tuple:
    """Compile the units of library ``name`` if its hashed library is
    missing: every unit into an object at once, then one link.  Returns
    ``(path, seconds, log)``.  Safe to run in several processes at once:
    each builds in a private temporary directory and renames the library
    into place."""
    srcs = _sources(name)
    h = hashlib.sha256()
    for path in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        with ThreadPoolExecutor(len(srcs)) as ex:
            logs = list(ex.map(
                lambda so: _nvcc_run([*NVCC_FLAGS, "-c", "-o", so[1],
                                      str(so[0])], so[0].name),
                zip(srcs, objs)))
        lib = os.path.join(tmp, out.name)
        _nvcc_run([*ARCH, "-shared", "-o", lib, *objs], f"lib{name}.so")
        os.replace(lib, out)
    return out, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (if needed) and load its library."""
    return ctypes.CDLL(str(compile_library(name)[0]))
