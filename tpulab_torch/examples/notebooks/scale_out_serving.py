# %% [markdown]
# # Scale-Out Serving: Replicas, Failover, Cache Affinity
# (reference examples/98_MultiProcessSingleStream + 99_LoadBalancer — the
# N-replicas-behind-a-balancer axis, here with tpulab's in-framework
# client-side routing; jupytext percent format)
#
# The reference scales out by launching one service per GPU and putting
# envoy in front.  tpulab keeps that deployment shape
# (`examples/99_loadbalancer/`: envoy config + measurement script) and
# adds zero-infrastructure client-side replica sets:
#
# - `ReplicaSet` — unary inference: least-loaded routing (round-robin at
#   the tie, like envoy), health probes, automatic failover (inference is
#   idempotent, so a retry cannot corrupt state)
# - `GenerationReplicaSet` — token streams: exactly-once failover (a
#   crashed replica's stream REPLAYS on a survivor, skipping delivered
#   tokens — deterministic because sampling is (seed, position)-keyed)
#   and optional prefix-cache-aware routing.
#
# The port of tpulab's notebooks/scale_out_serving.py: run as
# `python -m tpulab_torch.examples.notebooks.scale_out_serving
# [--device cpu]`.

# %%
import numpy as np

import tpulab_torch
from tpulab_torch.models import build_model
from tpulab_torch.rpc.replica import GenerationReplicaSet, ReplicaSet
from tpulab_torch.examples._device import notebook_device

DEVICE = notebook_device()   # --device cpu; default: the CUDA card

# %% [markdown]
# ## 1. Two replicas of a classifier, one router
# In production these are separate processes/hosts (98_multiprocess.sh);
# in-process managers keep the notebook hermetic.

# %%
replicas = []
for seed in (0, 0):  # identical weights: interchangeable replicas
    m = tpulab_torch.InferenceManager(max_exec_concurrency=2, max_buffers=4,
                                      device=DEVICE)
    m.register_model("mnist", build_model("mnist", max_batch_size=4,
                                          seed=seed, device=DEVICE))
    m.update_resources()
    m.serve(port=0)
    replicas.append(m)
addrs = [f"127.0.0.1:{m.server.bound_port}" for m in replicas]
rs = ReplicaSet(addrs, "mnist")
print("health:", rs.health())

# %%
x = np.zeros((1, 28, 28, 1), np.float32)
futs = [rs.infer(Input3=x) for _ in range(12)]
outs = [f.result(timeout=60) for f in futs]
print("12 requests ->", outs[0]["Plus214_Output_0"].shape,
      "split per replica:", rs.served)
assert all(s > 0 for s in rs.served)

# %% [markdown]
# ## 2. Failover: kill one replica mid-traffic
# The set routes around the corpse; requests keep completing.

# %%
replicas[1].shutdown()
outs = [rs.infer(Input3=x).result(timeout=60) for _ in range(6)]
health = rs.health()
print("after kill:", {a: h["live"] for a, h in health.items()},
      "split:", rs.served)
assert all(o["Plus214_Output_0"].shape == (1, 10) for o in outs)
rs.close()
replicas[0].shutdown()

# %% [markdown]
# ## 3. Generation scale-out with exactly-once failover
# Token streams are stateful server-side (KV sessions), so failover
# REPLAYS the request on a survivor and skips the tokens the consumer
# already received — greedy/seeded determinism makes the replay exact.

# %%
import torch

from tpulab_torch.engine.generation import GenerationEngine
from tpulab_torch.models.transformer import init_transformer_params

params = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                 n_layers=2, d_ff=64, device=DEVICE)
lm_replicas = []
for _ in range(2):
    eng = GenerationEngine(params, n_heads=2, n_layers=2, max_len=64,
                           max_sessions=2, compute_dtype=torch.float32,
                           device=DEVICE)
    m = tpulab_torch.InferenceManager(max_exec_concurrency=1, device=DEVICE)
    m.register_model("mnist", build_model("mnist", max_batch_size=1,
                                          device=DEVICE))
    m.update_resources()
    m.serve(port=0, generation_engines={"lm": eng})
    lm_replicas.append(m)
lm_addrs = [f"127.0.0.1:{m.server.bound_port}" for m in lm_replicas]

# %% [markdown]
# ## 4. Prefix-cache-aware routing
# `prefix_affinity=True` hashes each prompt's leading tokens to a stable
# home replica: repeats of a system prompt keep hitting the replica whose
# prefix cache already holds its KV pages.  Affinity is slack-bounded —
# an overloaded or dead home falls back to least-loaded.

# %%
grs = GenerationReplicaSet(lm_addrs, "lm", prefix_affinity=True,
                           affinity_tokens=4)
prompt = np.arange(6, dtype=np.int32)
for _ in range(3):
    toks = list(grs.generate(prompt, 8))
# all three repeats landed on ONE replica — the prompt's stable home
home = int(np.argmax(grs.served))
print(f"prompt home=replica{home}; 3 repeats served:", grs.served)
assert grs.served[home] == 3 and grs.served[1 - home] == 0

# %% [markdown]
# ## 5. Crash a stream's replica mid-generation
# The consumer sees one uninterrupted token sequence.

# %%
expected = toks
it = grs.generate(prompt, 8)
first3 = [next(it) for _ in range(3)]
lm_replicas[home].server.shutdown(grace_s=0.0)  # crash, not drain
rest = list(it)
print("across the crash:", first3 + rest)
assert first3 + rest == expected
grs.close()
for m in lm_replicas:
    try:
        m.shutdown()
    except Exception:
        pass

# %% [markdown]
# ## 6. Where envoy fits
# Client-side sets cover one client's view.  Cross-client balancing in
# deployment stays with the L7 balancer: `examples/99_loadbalancer/`
# ships the envoy config, `examples/deploy/` the k8s manifests, and
# `python -m tpulab_torch.examples.ex99_run_lb` — the
# measurement script comparing direct vs ReplicaSet vs envoy-proxied
# throughput (reference 99_LoadBalancer measured ~150 us/req overhead).

# %%
print("scale-out serving tour complete")
