# %% [markdown]
# # LLM Serving Tour: Paged KV, Prefix Caching, Speculation
# (a Demo-Day-style walkthrough of the serving layer the reference era
# predates — continuous batching over a paged KV pool, shared-prefix
# caching, token streaming, and speculative decoding; jupytext percent
# format: open in Jupyter or run as a script)
#
# The reference (trtlab) serves fixed-shape CNN inference; its pools and
# batcher generalize to LLM decode once the KV cache becomes the pooled
# resource.  The paged engine is that generalization: one decode step
# serves every mix of in-flight requests (lanes are masked), and K/V pages
# live in one pool on the card, read by the hand-written attention
# kernels.  The port of tpulab's notebooks/llm_serving.py: run as
# `python -m tpulab_torch.examples.notebooks.llm_serving [--device cpu]`.

# %%
import numpy as np
import torch

from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
from tpulab_torch.models.transformer import init_transformer_params
from tpulab_torch.examples._device import notebook_device

DEVICE = notebook_device()   # --device cpu; default: the CUDA card

params = init_transformer_params(vocab=256, d_model=128, n_heads=4,
                                 n_layers=2, d_ff=256, device=DEVICE)

# %% [markdown]
# ## 1. Continuous batching
# `submit()` returns a Future; a scheduler thread runs one fused decode
# tick over every active request — new arrivals join the moment a lane
# frees, nobody drains the batch.

# %%
cb = ContinuousBatcher(params, n_heads=4, n_layers=2, lanes=4, max_len=128,
                       page_size=16, compute_dtype=torch.float32,
                       prefix_cache=True, prefill_chunk=64, device=DEVICE)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, 256, (n,), np.int32) for n in (9, 17, 33)]
futs = [cb.submit(p, steps=12) for p in prompts]
for p, f in zip(prompts, futs):
    print(f"prompt[{len(p):2d} tok] ->", f.result(timeout=120)[:6], "...")

# %% [markdown]
# ## 2. Prefix caching (shared system prompts)
# Requests sharing a full-page-aligned prompt prefix reuse the cached KV
# pages (ref-counted, LRU-evicted under pool pressure) and prefill only
# their tail — the time-to-first-token win for few-shot preambles.

# %%
system = rng.integers(0, 256, (64,), np.int32)       # 4 full pages
users = [np.concatenate([system, rng.integers(0, 256, (k,), np.int32)])
         for k in (5, 9, 13)]
outs = [cb.submit(p, steps=4).result(timeout=120) for p in users]
print(f"prefix cache: {cb.prefix_cache.hits} page hits, "
      f"{cb.prefix_cache.misses} misses, {len(cb.prefix_cache)} entries")

# %% [markdown]
# ## 3. Token streaming + sampling
# `on_token` fires per decoded token (the hook the Generate RPC rides);
# `SamplingParams` selects temperature/top-k with a per-request PRNG, so
# a seeded request is reproducible regardless of batch-mates.

# %%
streamed = []
f = cb.submit(users[0], steps=8,
              on_token=lambda tok, i: streamed.append(tok),
              sampling=SamplingParams(temperature=0.7, top_k=40, seed=42))
result = f.result(timeout=120)
assert streamed == list(result)
print("streamed as decoded:", streamed)
cb.shutdown()

# %% [markdown]
# ## 4. Speculative decoding
# A small draft model proposes k tokens per round; the target verifies the
# whole chunk in ONE forward (`transformer_chunk_step`) and accepts the
# longest agreeing prefix — exact greedy equivalence, fewer target passes.

# %%
from tpulab_torch.engine.speculative import SpeculativeGenerator

draft = init_transformer_params(vocab=256, d_model=64, n_heads=2,
                                n_layers=1, d_ff=128, device=DEVICE)
spec = SpeculativeGenerator(params, draft, n_heads=4, n_layers=2,
                            draft_n_heads=2, draft_n_layers=1, k=4,
                            max_len=128, compute_dtype=torch.float32,
                            device=DEVICE)
out = spec.generate(prompts[0], steps=16)
print(f"speculative: {len(out)} tokens in {spec.rounds} verify rounds "
      f"(vs 16 sequential decode steps), {spec.accepted} draft tokens "
      "accepted")
print("done")
