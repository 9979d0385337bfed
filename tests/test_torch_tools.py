"""The port's two command-line tools held against tpulab's
``tools/onnx_summary.py`` and ``tools/build_engine.py`` on the same ONNX
bytes: ``python -m tpulab_torch.tools.onnx_summary`` (the import
preflight) and ``python -m tpulab_torch.tools.build_engine`` (an engine
artifact, its ``--verify-dir`` golden check, ``--device cpu``).  The
cases call ``main(argv)`` in process; one smoke run of each ``-m`` entry
point runs as a subprocess."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulab.models.onnx_import import load_onnx_model as j_load_onnx
from tpulab_torch.engine.runtime import Runtime
from tpulab_torch.tools import build_engine, onnx_summary

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_onnx_util as ou  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HIDDEN = 256
F32_BYTES = (6 * HIDDEN + HIDDEN + HIDDEN * 4 + 4) * 4


def _tpulab_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tpulab_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mlp_bytes(seed=0):
    """x (N, 6) -> Gemm -> Relu -> MatMul + Add -> Softmax (N, 4); both
    matrices large enough for the int8 import (1024 elements or more)."""
    rng = np.random.default_rng(seed)
    inits = {"w1": rng.standard_normal((6, HIDDEN)).astype(np.float32),
             "b1": rng.standard_normal(HIDDEN).astype(np.float32),
             "w2": (rng.standard_normal((HIDDEN, 4)) / 16).astype(np.float32),
             "b2": rng.standard_normal(4).astype(np.float32)}
    nodes = [ou.node("Gemm", ["x", "w1", "b1"], ["h"]),
             ou.node("Relu", ["h"], ["r"]),
             ou.node("MatMul", ["r", "w2"], ["m"]),
             ou.node("Add", ["m", "b2"], ["a"]),
             ou.node("Softmax", ["a"], ["y"], axis=-1)]
    return ou.model_bytes(nodes, inits, [("x", [1, 6])], [("y", [1, 4])])


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    d = tmp_path_factory.mktemp("mlp")
    path = d / "mlp.onnx"
    path.write_bytes(_mlp_bytes())
    return path


@pytest.fixture(scope="module")
def weird(tmp_path_factory):
    path = tmp_path_factory.mktemp("weird") / "weird.onnx"
    path.write_bytes(ou.model_bytes(
        [ou.node("NonMaxSuppression", ["x"], ["y"])], {},
        [("x", [1, 4])], [("y", [1, 4])]))
    return path


def test_summarize_matches_tpulab(mlp, weird, capsys):
    theirs = _tpulab_tool("onnx_summary")
    for path, rc in ((mlp, 0), (weird, 2)):
        got = onnx_summary.summarize(str(path))
        assert got == theirs.summarize(str(path))
        assert onnx_summary.main([str(path)]) == rc
        assert json.loads(capsys.readouterr().out) == got
    assert got["unsupported_ops"] == ["NonMaxSuppression"]
    assert got["importable"] is False
    mlp_rep = onnx_summary.summarize(str(mlp))
    assert mlp_rep["importable"] and mlp_rep["op_histogram"] == {
        "Gemm": 1, "Relu": 1, "MatMul": 1, "Add": 1, "Softmax": 1}
    assert mlp_rep["weight_bytes"] == F32_BYTES


def test_summarize_inventories_external_sidecars(tmp_path):
    """External data is listed, never read (the sidecar does not exist)."""
    ext = (ou.ld(1, b"w") + ou.vint(2, 1) + ou.vint(1, 4)
           + ou.ld(13, ou.ld(1, b"location") + ou.ld(2, b"w.bin"))
           + ou.vint(14, 1))
    g = (ou.ld(1, ou.node("Relu", ["x"], ["y"])) + ou.ld(2, b"ext")
         + ou.ld(5, ext) + ou.ld(11, ou.value_info("x", [1, 4]))
         + ou.ld(12, ou.value_info("y", [1, 4])))
    path = tmp_path / "ext.onnx"
    path.write_bytes(ou.vint(1, 7) + ou.ld(7, g)
                     + ou.ld(8, ou.ld(1, b"") + ou.vint(2, 13)))
    got = onnx_summary.summarize(str(path))
    assert got == _tpulab_tool("onnx_summary").summarize(str(path))
    assert got["external_sidecars"] == ["w.bin"]


def _golden(path, d, n=2, seed=3):
    """tpulab's imported model on ``n`` seeded rows -> zoo-style vectors."""
    x = np.random.default_rng(seed).standard_normal((n, 6)).astype(np.float32)
    jm = j_load_onnx(str(path))
    y = np.asarray(jm.apply_fn(jm.params, {"x": x})["y"])
    d.mkdir(exist_ok=True)
    (d / "input_0.pb").write_bytes(ou.tensor("x", x))
    (d / "output_0.pb").write_bytes(ou.tensor("y", y))
    return x, y


def test_build_engine_verifies_and_matches_tpulab(mlp, tmp_path, capsys):
    x, y = _golden(mlp, tmp_path / "test_data_set_0")
    out = tmp_path / "eng"
    assert build_engine.main(["--onnx", str(mlp), "--device", "cpu",
                              "--max-batch", "2", "--verify-dir",
                              str(tmp_path / "test_data_set_0"),
                              "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "# verified 1 output tensor(s)" in text
    rep = json.loads(text[text.index("{"):])
    assert sorted(rep) == ["buckets", "build_s", "engine", "model",
                           "weights_bytes"]
    assert rep["buckets"] == [1, 2] and rep["model"] == "testgraph"
    assert rep["weights_bytes"] == F32_BYTES
    loaded = Runtime("cpu").load_engine(str(out))
    got = loaded(2, {"x": torch.from_numpy(x)})["y"].numpy()
    np.testing.assert_allclose(got, y, rtol=1e-5, atol=1e-6)


def test_build_engine_refuses_a_wrong_or_empty_golden(mlp, tmp_path):
    d = tmp_path / "bad"
    _golden(mlp, d)
    (d / "output_0.pb").write_bytes(ou.tensor(
        "y", np.full((2, 4), 0.25, np.float32)))        # planted
    argv = ["--onnx", str(mlp), "--device", "cpu", "--max-batch", "2",
            "--out", str(tmp_path / "eng"), "--verify-dir"]
    with pytest.raises(AssertionError):
        build_engine.main(argv + [str(d)])
    assert not (tmp_path / "eng").exists()           # nothing written
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="compare nothing"):
        build_engine.main(argv + [str(empty)])


def test_build_engine_int8_quantizes_after_the_float_check(mlp, tmp_path,
                                                           capsys):
    _golden(mlp, tmp_path / "g")
    assert build_engine.main(["--onnx", str(mlp), "--device", "cpu",
                              "--int8", "--max-batch", "2", "--verify-dir",
                              str(tmp_path / "g"), "--out",
                              str(tmp_path / "q")]) == 0
    text = capsys.readouterr().out
    rep = json.loads(text[text.index("{"):])
    want = j_load_onnx(str(mlp), weight_quant="int8").weights_size_in_bytes()
    assert rep["weights_bytes"] == want < F32_BYTES
    assert "# verified" in text


def test_build_engine_mnist_roundtrip(tmp_path, capsys):
    """tpulab's ``test_build_engine_cli_roundtrip`` with ``--device cpu``
    (tpulab's ``--cpu``)."""
    assert build_engine.main(["--model", "mnist", "--max-batch", "2",
                              "--device", "cpu", "--out",
                              str(tmp_path / "eng")]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["buckets"] == [1, 2] and rep["model"] == "mnist"
    assert (tmp_path / "eng" / "spec.json").exists()
    compiled = Runtime("cpu").load_engine(str(tmp_path / "eng"))
    logits = compiled(2, {"Input3": torch.zeros((2, 28, 28, 1))})
    assert next(iter(logits.values())).shape == (2, 10)


def test_entry_points_as_processes(weird, tmp_path):
    """One run of each ``-m`` entry point: onnx_summary's exit code 2;
    build_engine on the CPU when asked, and refusing to run anywhere but
    the card when not (this host has none)."""
    run = subprocess.run([sys.executable, "-m",
                          "tpulab_torch.tools.onnx_summary", str(weird)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 2, run.stderr[-2000:]
    assert json.loads(run.stdout)["unsupported_ops"] == ["NonMaxSuppression"]
    run = subprocess.run([sys.executable, "-m",
                          "tpulab_torch.tools.build_engine", "--model",
                          "mnist", "--max-batch", "1", "--out",
                          str(tmp_path / "eng"), "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout)["buckets"] == [1]
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, "-m",
                              "tpulab_torch.tools.build_engine", "--out",
                              str(tmp_path / "no")], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0 and "no CUDA device" in run.stderr
        assert not (tmp_path / "no").exists()
