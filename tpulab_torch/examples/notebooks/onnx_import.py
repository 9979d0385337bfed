# %% [markdown]
# # Bring Your Own Model: ONNX Import
# (the reference's examples/ONNX workflow — parse a graph, build an
# engine, golden-check against the zoo's bundled vectors, serve — as a
# walkthrough; jupytext percent format: open in Jupyter or run as a
# script)
#
# No `onnx` package is needed: `tpulab_torch.models.onnx_import` carries a
# protobuf wire-format reader and evaluates the graph as written (NCHW)
# with PyTorch ops.  The port of tpulab's notebooks/onnx_import.py: run as
# `python -m tpulab_torch.examples.notebooks.onnx_import [--device cpu]
# [--zoo DIR]` (DIR holds model.onnx and test_data_set_0/).

# %%
import argparse
import os

import numpy as np
import torch

from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.models.onnx_import import load_onnx_model, load_tensor_pb
from tpulab_torch.examples._device import notebook_device

DEVICE = notebook_device()   # --device cpu; default: the CUDA card

_ap = argparse.ArgumentParser()
_ap.add_argument("--zoo", default="mnist-v1.3")   # the model zoo's directory
ZOO = _ap.parse_known_args()[0].zoo
if not os.path.isdir(ZOO):  # graceful skip outside the build image
    print("zoo artifact not present; notebook exits")
    raise SystemExit(0)

# %% [markdown]
# ## 1. Import
# One call parses the protobuf, builds the op graph, and discovers the
# IO contract.  The leading dim is the batch axis: the engine layer
# re-batches per bucket, even though this zoo model was exported at N=1.

# %%
model = load_onnx_model(os.path.join(ZOO, "model.onnx"),
                        name="mnist_onnx", max_batch_size=4, device=DEVICE)
print(model)
print("inputs:", [(s.name, s.shape, s.np_dtype.name) for s in model.inputs])

# %% [markdown]
# ## 2. Golden check
# The ONNX zoo bundles `test_data_set_*` TensorProto vectors; the
# reference's `run_onnx_tests` compares against them and so do we.

# %%
x = load_tensor_pb(os.path.join(ZOO, "test_data_set_0", "input_0.pb"))
want = load_tensor_pb(os.path.join(ZOO, "test_data_set_0", "output_0.pb"))
with torch.inference_mode():
    got = model.apply_fn(model.params, {"Input3": torch.from_numpy(
        x.copy()).to(resolve_device(DEVICE))})["Plus214_Output_0"]
got = got.cpu().numpy()
np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
print("golden check vs bundled vectors: OK")

# %% [markdown]
# ## 3. Serve it like any model
# Imported models are ordinary `Model` objects: register, compile per
# bucket, infer through the pooled pipeline — at batch sizes the export
# never saw.

# %%
import tpulab_torch

manager = tpulab_torch.InferenceManager(max_exec_concurrency=2, device=DEVICE)
manager.register_model("mnist_onnx", model)
manager.update_resources()
x3 = np.concatenate([x, x, x], axis=0)            # batch 3 -> bucket 4
out = manager.infer_runner("mnist_onnx").infer(Input3=x3).result(timeout=120)
print("served batched output:", out["Plus214_Output_0"].shape)
for row in out["Plus214_Output_0"]:
    np.testing.assert_allclose(row[None], want, rtol=1e-3, atol=1e-3)
print("served rows match the golden vector: OK")

# %% [markdown]
# ## 4. Weight-only INT8
# `weight_quant="int8"` stores eligible Conv/MatMul/Gemm weights as
# `{w_int8, scale}` (per-output-channel for conv kernels) and dequants
# in the consuming op's epilogue — 4x less weight HBM and read
# bandwidth, the imported-model analog of the reference's INT8 engines.

# %%
qmodel = load_onnx_model(os.path.join(ZOO, "model.onnx"),
                         name="mnist_onnx_i8", max_batch_size=4,
                         weight_quant="int8", device=DEVICE)
with torch.inference_mode():
    qgot = qmodel.apply_fn(qmodel.params, {"Input3": torch.from_numpy(
        x.copy()).to(resolve_device(DEVICE))})["Plus214_Output_0"]
qgot = qgot.cpu().numpy()
err = float(np.abs(qgot - want).max())
print(f"int8 max abs err vs golden: {err:.4f} (float path: "
      f"{float(np.abs(got - want).max()):.4f})")

# %% [markdown]
# ## 5. Offline build, online serve
# `Runtime.save_engine` writes a portable artifact (exported programs +
# weights); `load_engine` reloads it with **no Python source and no
# .onnx file** — the TRT plan-file property.

# %%
import tempfile

from tpulab_torch.engine import Runtime

with tempfile.TemporaryDirectory() as d:
    rt = Runtime(DEVICE)
    rt.save_engine(rt.compile_model(model), d)
    loaded = Runtime(DEVICE).load_engine(d)
    with torch.inference_mode():
        lgot = loaded(1, {"Input3": torch.from_numpy(x.copy()).to(
            resolve_device(DEVICE))})["Plus214_Output_0"]
    np.testing.assert_allclose(lgot.cpu().numpy(), want, rtol=1e-3,
                               atol=1e-3)
    print("portable artifact reload: OK")

manager.shutdown()
print("notebook complete")
