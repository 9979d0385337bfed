"""Generation engine: session-pooled autoregressive serving (the port of
``tpulab/engine/generation.py``, the Generate RPC's dense path).

KV caches are the activation scratch of generative serving, so they get
the treatment the reference gives execution contexts: preallocated,
pooled, leased per request with blocking backpressure.

- :class:`GenerationEngine` — owns the device weights, the decode step
  and the batch ``generate`` program (the port's
  :func:`~tpulab_torch.models.transformer.make_generate_fn`), and a
  :class:`~tpulab_torch.core.pool.Pool` of cache slots.
- :class:`GenerationSession` — one leased cache slot: ``prefill(tokens)``
  then ``step()`` per token (streaming), or ``generate(prompt, n)`` one-shot.

PyTorch runs the decode step eagerly and writes each token's K/V into the
slot in place (tpulab's functional step returns a new cache and leaves
the pooled one zero).  A reused slot therefore holds an earlier
session's entries past the new session's position; they are never read,
because a step attends positions up to its own only and every position
below it was written by this session first.
"""

from __future__ import annotations

import time as _time
from functools import partial
from typing import Any, Iterator, Optional

import numpy as np
import torch

from tpulab_torch import chaos
from tpulab_torch.core.deadline import Deadline
from tpulab_torch.core.pool import Pool, PoolItem
from tpulab_torch.engine.runtime import tree_to


class GenerationEngine:
    """Pooled generation over the port's transformer family.

    ``params`` is a :class:`~tpulab_torch.models.transformer.Transformer`
    or a tpulab-keyed tree of tensors; ``device=None`` means the CUDA
    card (raises without one), tests pass ``device="cpu"``."""

    def __init__(self, params: Any, n_heads: int, n_layers: int,
                 max_len: int = 1024, max_sessions: int = 2,
                 compute_dtype=None, device=None,
                 n_kv_heads: Optional[int] = None,
                 rope_theta: Optional[float] = None):
        from tpulab_torch.cuda.platform import resolve_device
        from tpulab_torch.models.transformer import (_tree, init_kv_cache,
                                                     make_generate_fn,
                                                     transformer_decode_step,
                                                     weight_shape)

        self.device = resolve_device(device)
        compute_dtype = compute_dtype or torch.bfloat16
        self.compute_dtype = compute_dtype
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads or n_heads
        self.max_len = max_len
        tree = _tree(params)
        self.params = tree_to(tree, self.device)
        d_model = weight_shape(tree["layer0"]["wqkv"])[0]
        self.head_dim = d_model // n_heads
        #: id-validation bound (public: the Generate RPC checks it)
        self.vocab = int(weight_shape(tree["embed"])[0])

        self._decode = partial(
            transformer_decode_step, n_heads=n_heads, n_layers=n_layers,
            compute_dtype=compute_dtype, n_kv_heads=self.n_kv_heads,
            rope_theta=rope_theta)
        self._generate = make_generate_fn(self.params, n_heads, n_layers,
                                          max_len, compute_dtype,
                                          n_kv_heads=self.n_kv_heads,
                                          rope_theta=rope_theta)
        # cache slots hold the compact n_kv_heads form under GQA: the
        # generation analog of execution-context pooling
        self._init_cache = partial(init_kv_cache, 1, max_len, n_layers,
                                   self.n_kv_heads, self.head_dim,
                                   compute_dtype, self.device)
        self._sessions: Pool = Pool(
            (self._init_cache() for _ in range(max_sessions)))

    def _check_ids(self, tokens: np.ndarray) -> None:
        """Host-boundary id validation: an out-of-range id would fault the
        embedding gather on the card — reject here, as
        ContinuousBatcher.submit does, so direct library callers are
        covered, not just the Generate RPC."""
        if tokens.size and (tokens.min() < 0 or tokens.max() >= self.vocab):
            raise ValueError(f"prompt token ids outside [0, {self.vocab})")

    # -- one-shot -----------------------------------------------------------
    def generate(self, prompt: np.ndarray, steps: int) -> np.ndarray:
        """Batch greedy generation (prompt replay + cached decode)."""
        prompt = np.asarray(prompt)
        self._check_ids(prompt)
        return self._generate(torch.as_tensor(prompt), steps).cpu().numpy()

    # -- streaming sessions --------------------------------------------------
    def start_session(self, timeout: Optional[float] = None
                      ) -> "GenerationSession":
        """Lease a cache slot; blocks when all sessions are busy.  The
        blocking wait is recorded on the session (``lease_wait_s``) — the
        dense engine's queue-wait, observable by serving telemetry."""
        t0 = _time.perf_counter()
        item = self._sessions.pop(timeout)
        return GenerationSession(self, item,
                                 lease_wait_s=_time.perf_counter() - t0)

    @property
    def available_sessions(self) -> int:
        return self._sessions.available


class GenerationSession:
    """One leased KV-cache slot (close/GC returns it to the pool)."""

    def __init__(self, engine: GenerationEngine, item: PoolItem,
                 lease_wait_s: float = 0.0):
        self._engine = engine
        self._item = item
        self._cache = item.get()
        self._pos = 0
        self._last_logits = None
        self._closed = False
        #: seconds this lease blocked on the session pool (queue wait)
        self.lease_wait_s = lease_wait_s

    @property
    def position(self) -> int:
        return self._pos

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("generation session is closed")

    def _feed(self, token: int) -> None:
        eng = self._engine
        tok = torch.tensor([int(token)], dtype=torch.int64, device=eng.device)
        with torch.inference_mode():
            self._last_logits, self._cache = eng._decode(
                eng.params, self._cache, tok, self._pos)
        self._pos += 1

    def _argmax(self) -> int:
        return int(self._last_logits.argmax(-1)[0])

    def prefill(self, tokens: np.ndarray) -> None:
        """Feed prompt tokens ((T,) int32) through decode steps."""
        self._check_open()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        self._engine._check_ids(tokens)
        if self._pos + len(tokens) > self._engine.max_len:
            raise ValueError(f"session length {self._pos + len(tokens)} "
                             f"exceeds max_len {self._engine.max_len}")
        for t in tokens:
            self._feed(int(t))

    def step(self, token: Optional[int] = None) -> int:
        """Advance one token; ``token=None`` feeds back the greedy argmax
        of the last logits (generation), else feeds the given token
        (teacher-forced scoring).  Returns the next predicted token."""
        self._check_open()
        if self._last_logits is None and token is None:
            raise RuntimeError("prefill before generating")
        if token is None:
            token = self._argmax()
        elif not 0 <= int(token) < self._engine.vocab:
            raise ValueError(f"token id {token} outside "
                             f"[0, {self._engine.vocab})")
        if self._pos >= self._engine.max_len:
            raise ValueError(f"session exceeded max_len {self._engine.max_len}")
        # chaos: per-decode-step fault site (transient failure / slow step)
        chaos.trip("engine.step")
        self._feed(int(token))
        return self._argmax()

    def stream(self, steps: int,
               deadline: Optional[Deadline] = None) -> Iterator[int]:
        """Yield ``steps`` greedily generated tokens.  An expired
        ``deadline`` raises DeadlineExceeded BEFORE the next decode step
        (library-caller analog of the Generate RPC's per-token check)."""
        tok = None
        for _ in range(steps):
            if deadline is not None:
                deadline.check("generation")
            tok = self.step(tok)
            yield tok

    def close(self) -> None:
        """Return the cache slot (module docstring: the next lease reuses
        it as it is)."""
        if not self._closed:
            self._closed = True
            self._cache = None
            self._item.release()

    def __enter__(self) -> "GenerationSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
