"""Dense speculative decoding — the port of ``tpulab/engine/speculative.py``.

A draft model proposes ``k`` tokens and the target verifies all of them
in ONE chunked forward (:func:`~tpulab_torch.models.transformer.
transformer_chunk_step`): ``a + 1`` tokens per target forward, where
``a`` is the accepted prefix.  Greedy acceptance: accept draft tokens
while they equal the target's own greedy choice, then emit the target's
correction (or bonus) token, so the output is EXACTLY the target's
greedy sequence.  Both dense KV caches tolerate rejected writes because
positions only advance.

.. note:: This is the dense path: one session, one ``max_len`` cache per
   model, attention in plain tensor math (tpulab computes it outside
   any Pallas kernel too).  Serving speculates inside the batcher's
   paged blocks instead: ``ContinuousBatcher(draft_params=...,
   draft_n_layers=...)`` (:mod:`tpulab_torch.engine.paged`).  This path
   stays for the dense session adapter and as the acceptance-rule
   reference.  tpulab's acceptance microbenchmark of it is
   :func:`benchmark_speculative`.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from tpulab_torch.core.deadline import Deadline
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.engine.paged import _tree_to
from tpulab_torch.models.transformer import (  # noqa: F401 (re-export)
    _tree, early_exit_draft, init_kv_cache, transformer_chunk_step,
    transformer_decode_step)


class SpeculativeGenerator:
    """Greedy speculative decoding over two transformer-family models
    (trees or :class:`~tpulab_torch.models.transformer.Transformer`s).
    ``device=None`` means the CUDA card (raises without one)."""

    def __init__(self, target_params: Any, draft_params: Any, *,
                 n_heads: int, n_layers: int,
                 draft_n_heads: Optional[int] = None,
                 draft_n_layers: Optional[int] = None,
                 k: int = 4, max_len: int = 1024,
                 compute_dtype=None, device=None,
                 n_kv_heads: Optional[int] = None,
                 draft_n_kv_heads: Optional[int] = None,
                 rope_theta: Optional[float] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.max_len = max_len
        self.device = resolve_device(device)
        cdt = compute_dtype or torch.float32
        target, draft = _tree(target_params), _tree(draft_params)
        #: id-validation bound
        self.vocab = int(target["embed"].shape[0])
        self.target_params = _tree_to(target, self.device)
        self.draft_params = _tree_to(draft, self.device)
        dh = draft_n_heads or n_heads
        dl = draft_n_layers or n_layers
        t_kv = n_kv_heads or n_heads
        # a same-arch draft (draft_n_heads omitted) inherits the target's
        # KV head count; an explicit draft arch defaults to MHA
        d_kv = draft_n_kv_heads or (t_kv if draft_n_heads is None else dh)
        t_dim = target["embed"].shape[1] // n_heads
        d_dim = draft["embed"].shape[1] // dh
        self._t_cache = functools.partial(init_kv_cache, 1, max_len,
                                          n_layers, t_kv, t_dim, cdt,
                                          self.device)
        self._d_cache = functools.partial(init_kv_cache, 1, max_len, dl,
                                          d_kv, d_dim, cdt, self.device)
        self._verify = functools.partial(
            transformer_chunk_step, n_heads=n_heads, n_layers=n_layers,
            compute_dtype=cdt, n_kv_heads=n_kv_heads, rope_theta=rope_theta)
        self._d_prefill = functools.partial(
            transformer_chunk_step, n_heads=dh, n_layers=dl,
            compute_dtype=cdt, n_kv_heads=d_kv, rope_theta=rope_theta)
        self._d_step = functools.partial(
            transformer_decode_step, n_heads=dh, n_layers=dl,
            compute_dtype=cdt, n_kv_heads=d_kv, rope_theta=rope_theta)

    def _propose(self, cache, tok, pos0: int):
        """k draft tokens (k,) from ``tok`` at ``pos0``.  k+1 steps: the
        extra one FEEDS drafts[k-1] so its K/V lands in the draft cache (a
        fully accepted round advances past pos0+k); its output is
        discarded."""
        toks = []
        for i in range(self.k + 1):
            logits, cache = self._d_step(self.draft_params, cache, tok,
                                         pos0 + i)
            tok = logits.argmax(-1)
            toks.append(tok[0])
        return torch.stack(toks[:self.k])

    # -- public --------------------------------------------------------------
    def stream(self, prompt, steps: int):
        """Yield exactly ``steps`` greedy tokens as they are VERIFIED, one
        burst per speculation round.  Each call owns fresh KV caches.
        ``rounds`` / ``accepted`` of the last finished call stay on the
        instance.  Validation is eager (at call time)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size and (prompt.min() < 0 or prompt.max() >= self.vocab):
            # an out-of-range id would fault the embedding gather on the
            # card; reject at the host boundary
            raise ValueError(f"prompt token ids outside [0, {self.vocab})")
        t_p = prompt.shape[0]
        if max(t_p + steps + self.k + 1,
               1 << (t_p - 1).bit_length()) > self.max_len:
            raise ValueError("prompt+steps+k exceeds max_len")
        if steps <= 0:  # the exactly-steps contract holds at zero too
            self.rounds = self.accepted = 0
            return iter(())
        return self._stream_impl(prompt, t_p, steps)

    def _stream_impl(self, prompt, t_p: int, steps: int):
        with torch.inference_mode():
            t_cache, d_cache = self._t_cache(), self._d_cache()
            # prefill both models with one chunked forward (pow2 bucket)
            padded = np.zeros((1, 1 << (t_p - 1).bit_length()), np.int64)
            padded[0, :t_p] = prompt
            padded = torch.as_tensor(padded, device=self.device)
            tl, t_cache = self._verify(self.target_params, t_cache, padded, 0)
            _, d_cache = self._d_prefill(self.draft_params, d_cache, padded,
                                         0)
            cur = int(tl[0, t_p - 1].argmax())
        emitted_n = 1
        yield cur
        p = t_p                     # tokens FED to the target so far
        rounds = accepted = 0
        while emitted_n < steps:
            with torch.inference_mode():
                cur_t = torch.tensor([cur], device=self.device)
                drafts = self._propose(d_cache, cur_t, p)
                chunk = torch.cat([cur_t, drafts])[None, :]     # (1, k+1)
                logits, t_cache = self._verify(self.target_params, t_cache,
                                               chunk, p)
                both = torch.cat([drafts, logits[0].argmax(-1)]).cpu()
            drafts, greedy = both[:self.k].tolist(), both[self.k:].tolist()
            # accept the agreeing prefix; the correction (or the bonus
            # after a full match) is always emitted
            a = 0
            while a < self.k and drafts[a] == greedy[a]:
                a += 1
            cur = int(greedy[a])
            p += a + 1
            rounds += 1
            accepted += a
            for tok in drafts[:a] + [cur]:
                if emitted_n < steps:
                    emitted_n += 1
                    yield int(tok)
        self.rounds = rounds
        self.accepted = accepted

    def generate(self, prompt, steps: int) -> List[int]:
        """Greedy-decode ``steps`` tokens: exactly the target's greedy
        continuation (see :meth:`stream`)."""
        return list(self.stream(prompt, steps))


class _SpeculativeSession:
    """One admitted decode: usable directly (``close()``) or as a context
    manager, in the dense session's shape.  The semaphore slot releases
    exactly once: on close/exit or, as a last resort, at GC."""

    def __init__(self, spec: SpeculativeGenerator, sem, on_close=None):
        self._spec = spec
        self._sem = sem
        self._on_close = on_close
        self._prompt: Optional[np.ndarray] = None
        self._completed = False
        self._served = 0
        self._errored = False
        self._closed = False

    def prefill(self, prompt) -> None:
        if self._closed:
            raise RuntimeError("session is closed")
        self._prompt = np.asarray(prompt, np.int32).reshape(-1)

    def stream(self, steps: int, deadline: Optional[Deadline] = None):
        if self._closed:
            raise RuntimeError("session is closed")
        if self._prompt is None:
            raise RuntimeError("prefill() before stream()")
        inner = self._spec.stream(self._prompt, steps)
        if deadline is not None:
            # checked at burst boundaries: verified tokens still stream,
            # the NEXT round is what stops
            inner = self._deadlined(inner, deadline)

        def counted():
            # complete when the stream is exhausted, or closed early by the
            # consumer after >= 1 served token (the stop-token break); an
            # errored stream never counts
            try:
                for tok in inner:
                    self._served += 1
                    yield tok
            except GeneratorExit:   # early close by the consumer: no error
                raise
            except BaseException:
                self._errored = True
                raise
            self._completed = True

        return counted()

    @staticmethod
    def _deadlined(inner, deadline):
        # check BEFORE pulling the next round, so verified tokens still
        # reach the consumer and no compute starts past expiry
        while True:
            deadline.check("generation")
            try:
                tok = next(inner)
            except StopIteration:
                return
            yield tok

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._sem.release()
            if ((self._completed or (self._served > 0
                                     and not self._errored))
                    and self._on_close is not None):
                self._on_close()

    def __enter__(self) -> "_SpeculativeSession":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):  # GC fallback; close() is idempotent
        self.close()


class SpeculativeSessionEngine:
    """Serving adapter: a :class:`SpeculativeGenerator` behind the dense
    session interface (``start_session`` -> ``prefill`` / ``stream``)
    that a Generate service takes once one is ported.  Tokens stream in
    verified bursts; sessions are admission tokens (``max_sessions``
    bounds concurrent decodes).  The batcher's paged path supersedes it
    for serving."""

    def __init__(self, spec: SpeculativeGenerator, max_sessions: int = 2):
        self._spec = spec
        self._sem = threading.BoundedSemaphore(max_sessions)
        self._count_lock = threading.Lock()
        #: sessions that streamed and closed (success only, as the
        #: batcher's completed_requests)
        self.completed_requests = 0

    def _count_completion(self) -> None:
        with self._count_lock:
            self.completed_requests += 1

    @property
    def vocab(self):
        return self._spec.vocab

    @property
    def rounds(self):
        return getattr(self._spec, "rounds", 0)

    @property
    def accepted(self):
        return getattr(self._spec, "accepted", 0)

    def start_session(self, timeout: Optional[float] = None
                      ) -> _SpeculativeSession:
        if not self._sem.acquire(timeout=timeout):
            raise TimeoutError("no speculative session available")
        return _SpeculativeSession(self._spec, self._sem,
                                   on_close=self._count_completion)


def benchmark_speculative(n_heads: int = 8, n_layers: int = 8,
                          d_model: int = 512, d_ff: int = 2048,
                          vocab: int = 2048, draft_layers: int = 2,
                          k: int = 4, steps: int = 128,
                          prompt_len: int = 16, max_len: int = 512,
                          compute_dtype=None, seed: int = 0,
                          tail_scale: float = 0.05, params=None,
                          device=None):
    """Acceptance and tok/s of dense speculative against plain greedy
    decode (tpulab's ``speculative`` row, the acceptance-mechanics
    microbenchmark beside the serving-path
    :func:`~tpulab_torch.engine.paged.benchmark_speculative_decode`).

    The target's layers past the draft exit have ``wo`` / ``w2`` scaled by
    ``tail_scale`` (new tensors): the trained-model emulation, without
    which random late layers flip every near-uniform argmax.  Plain decode
    is a host loop over one decode step after the same pow2-padded
    chunked prefill, as a generation engine streams; ``exact_match`` says
    speculation gave exactly the plain greedy tokens."""
    import time

    from tpulab_torch.engine.paged import _bench_tree, _scaled_tail

    dev = resolve_device(device)
    cdt = compute_dtype or torch.float32
    target = _scaled_tail(
        _bench_tree(params, dev, vocab, d_model, n_heads, n_layers, d_ff,
                    seed=seed),
        draft_layers, n_layers, tail_scale)
    draft = early_exit_draft(target, draft_layers)
    spec = SpeculativeGenerator(
        target, draft, n_heads=n_heads, n_layers=n_layers,
        draft_n_heads=n_heads, draft_n_layers=draft_layers, k=k,
        max_len=max_len, compute_dtype=cdt, device=dev)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, vocab, (prompt_len,)).astype(np.int32)

    spec.generate(prompt, 8)                   # warm both programs
    t0 = time.perf_counter()
    spec_toks = spec.generate(prompt, steps)
    spec_s = time.perf_counter() - t0
    acceptance = spec.accepted / max(spec.rounds * k, 1)

    target_dev = spec.target_params
    kw = dict(n_heads=n_heads, n_layers=n_layers, compute_dtype=cdt)
    head_dim = d_model // n_heads

    def plain(n: int) -> List[int]:
        with torch.inference_mode():
            cache = init_kv_cache(1, max_len, n_layers, n_heads, head_dim,
                                  cdt, dev)
            padded = np.zeros((1, 1 << (prompt_len - 1).bit_length()),
                              np.int64)
            padded[0, :prompt_len] = prompt
            logits, cache = transformer_chunk_step(
                target_dev, cache, torch.as_tensor(padded, device=dev), 0,
                **kw)
            cur = int(logits[0, prompt_len - 1].argmax())
            out = [cur]
            pos = prompt_len
            while len(out) < n:
                lg, cache = transformer_decode_step(
                    target_dev, cache, torch.tensor([cur], device=dev), pos,
                    **kw)
                cur = int(lg[0].argmax())
                out.append(cur)
                pos += 1
        return out

    plain(8)                                   # warm
    t0 = time.perf_counter()
    plain_toks = plain(steps)
    plain_s = time.perf_counter() - t0

    return {"k": k, "draft_layers": draft_layers, "n_layers": n_layers,
            "steps": steps, "acceptance": acceptance,
            "rounds": spec.rounds,
            "spec_tok_s": steps / spec_s,
            "plain_tok_s": steps / plain_s,
            "speedup": plain_s / spec_s,
            "exact_match": bool(spec_toks == plain_toks)}

