"""The port stands alone: tpulab_torch and chip_smoke.py import no JAX, no
ml_dtypes and nothing of the tpulab package (the machine with the card
has none of them).

Module names are matched exactly: ``tpulab_torch`` starts with the
letters ``tpulab`` but is not ``tpulab`` or ``tpulab.*``.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import tpulab_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpulab_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "tpulab"
            or name.startswith("tpulab.") or name == "ml_dtypes"
            or name.startswith("ml_dtypes."))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpulab_torch.__path__, prefix="tpulab_torch."))


def test_forbidden_matches_exact_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("tpulab") and _forbidden("tpulab.engine.paged")
    assert _forbidden("ml_dtypes") and _forbidden("tpulab.disagg.wire")
    assert not _forbidden("tpulab_torch") and not _forbidden(
        "tpulab_torch.engine.paged") and not _forbidden("jaxtyping")


def test_importing_every_module_loads_no_jax_or_tpulab():
    mods = _modules()
    assert {"tpulab_torch.engine.paged", "tpulab_torch.engine.speculative",
            "tpulab_torch.chaos", "tpulab_torch.cuda.transfer",
            "tpulab_torch.kvcache.host_store", "tpulab_torch.kvcache.offload",
            "tpulab_torch.disagg.wire",
            "tpulab_torch.disagg.shipper"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_sources_import_no_jax_or_tpulab():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert len(files) > 10 and not bad, bad
