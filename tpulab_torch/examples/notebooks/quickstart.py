# %% [markdown]
# # tpulab Quickstart
# (reference notebooks: Quickstart.ipynb / Demo Day 1-3 / Multiple Models —
# as a jupytext percent-format script: open in Jupyter or run as
# `python -m tpulab_torch.examples.notebooks.quickstart [--device cpu]`;
# the port of tpulab's notebooks/quickstart.py)
#
# Build a model, register it with an InferenceManager, run local inference,
# serve it over gRPC, and call it remotely.

# %%
import numpy as np
import tpulab_torch
from tpulab_torch.models import build_model
from tpulab_torch.examples._device import notebook_device

DEVICE = notebook_device()   # --device cpu; default: the CUDA card

# %% [markdown]
# ## 1. Local serving (Demo Day 1)

# %%
manager = tpulab_torch.InferenceManager(max_exec_concurrency=2, device=DEVICE)
manager.register_model("mnist", build_model("mnist", max_batch_size=4,
                                            device=DEVICE))
manager.update_resources()

runner = manager.infer_runner("mnist")
x = np.random.default_rng(0).standard_normal((1, 28, 28, 1)).astype(np.float32)
future = runner.infer(Input3=x)          # async: returns immediately
outputs = future.result()                # InferFuture.get()
print("logits:", outputs["Plus214_Output_0"].round(2))

# %% [markdown]
# ## 2. Multiple models, one device (Multiple Models.ipynb)
# Per-model context pools share one global execution-token pool — concurrent
# traffic to any mix of models is bounded by `max_exec_concurrency`.

# %%
manager2 = tpulab_torch.InferenceManager(max_exec_concurrency=2,
                                         device=DEVICE)
manager2.register_model("m_a", build_model("mnist", max_batch_size=2, seed=1,
                                           device=DEVICE))
manager2.register_model("m_b", build_model("mnist", max_batch_size=2, seed=2,
                                           device=DEVICE))
manager2.update_resources()
futures = [manager2.infer_runner(m).infer(Input3=x)
           for m in ("m_a", "m_b") for _ in range(4)]
print("completed:", len([f.result() for f in futures]))
manager2.shutdown()

# %% [markdown]
# ## 3. Serve + remote client (Demo Day 2/3)

# %%
manager.serve(port=0)                     # TRTIS-style gRPC service
remote = tpulab_torch.RemoteInferenceManager(f"localhost:{manager.server.bound_port}")
print("remote models:", sorted(remote.get_models()))
remote_out = remote.infer_runner("mnist").infer(Input3=x).result()
np.testing.assert_allclose(remote_out["Plus214_Output_0"],
                           outputs["Plus214_Output_0"], rtol=1e-5)
print("remote == local ✓")

# %% [markdown]
# ## 4. Benchmark (InferBench)

# %%
from tpulab_torch.engine import InferBench

result = InferBench(manager).run("mnist", batch_size=4, seconds=1.0)
print({k: round(v, 1) for k, v in result.items()})

# %%
remote.close()
manager.shutdown()
