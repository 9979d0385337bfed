# %% [markdown]
# # Multiple Models, One Chip
# (reference `notebooks/Multiple Models.ipynb` — the walkthrough of serving
# several models from one InferenceManager, with per-model concurrency
# budgets under one global execution-token pool; jupytext percent format)
#
# The resource model (reference inference_manager.cc:151-155, 254-273):
# - ONE global pool of execution tokens bounds total in-flight dispatches
#   on the chip (`max_exec_concurrency`)
# - each model gets its OWN pool of execution-context slots
#   (`max_concurrency=` at registration)
# - an inference needs BOTH: the two-level pop means a burst on model A
#   cannot starve the chip, and a model's own budget caps its share.
#
# The port of tpulab's notebooks/multiple_models.py: run as
# `python -m tpulab_torch.examples.notebooks.multiple_models [--device cpu]`.

# %%
import time

import numpy as np

import tpulab_torch
from tpulab_torch.models import build_model
from tpulab_torch.examples._device import notebook_device

DEVICE = notebook_device()   # --device cpu; default: the CUDA card

# %% [markdown]
# ## 1. Register two models with different concurrency budgets
# `big` may use the whole chip budget (4); `small` is capped at 1 slot —
# the per-model knob the reference exposes per engine.

# %%
manager = tpulab_torch.InferenceManager(max_exec_concurrency=4, device=DEVICE)
manager.register_model("big", build_model("mnist", max_batch_size=8, seed=0,
                                          device=DEVICE),
                       max_concurrency=4)
manager.register_model("small", build_model("mnist", max_batch_size=8, seed=1,
                                            device=DEVICE),
                       max_concurrency=1)
manager.update_resources()
print("models:", manager.model_names)

# %% [markdown]
# ## 2. Mixed concurrent traffic
# Fire interleaved requests at both; futures resolve as tokens free up.

# %%
x = np.random.default_rng(0).standard_normal((4, 28, 28, 1)).astype(np.float32)
runners = {m: manager.infer_runner(m) for m in ("big", "small")}
t0 = time.perf_counter()
futures = [(m, runners[m].infer(Input3=x))
           for _ in range(8) for m in ("big", "small")]
results = [(m, f.result(timeout=120)) for m, f in futures]
print(f"{len(results)} inferences in {time.perf_counter() - t0:.2f}s")

# %% [markdown]
# ## 3. The budgets in action
# Saturate `small` (1 slot): its requests serialize, but `big` keeps the
# remaining 3 tokens busy — per-model isolation under one chip budget.

# %%
t0 = time.perf_counter()
small_futs = [runners["small"].infer(Input3=x) for _ in range(6)]
big_futs = [runners["big"].infer(Input3=x) for _ in range(6)]
[f.result(timeout=120) for f in [*small_futs, *big_futs]]
print(f"saturated mix drained in {time.perf_counter() - t0:.2f}s "
      f"(small serialized on its 1 slot; big rode the other tokens)")

# %% [markdown]
# ## 4. Serve both models from one endpoint

# %%
manager.serve(port=0)
from tpulab_torch.rpc.infer_service import RemoteInferenceManager

remote = RemoteInferenceManager(f"localhost:{manager.server.bound_port}")
print("served models:", sorted(remote.get_models()))
for name in ("big", "small"):
    out = remote.infer_runner(name).infer(Input3=x).result(timeout=120)
    local = runners[name].infer(Input3=x).result(timeout=120)
    np.testing.assert_allclose(out["Plus214_Output_0"],
                               local["Plus214_Output_0"], rtol=1e-5)
print("remote == local for both models")

# %%
remote.close()
manager.shutdown()
