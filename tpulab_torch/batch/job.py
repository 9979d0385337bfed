"""Batch-job manifest + durable JSONL result sink (tpulab_torch.batch, the
port of ``tpulab/batch/job.py``; manifests and records are tpulab's).

A :class:`BatchJob` is the unit of offline work: a list of prompts that
share one sampling config and step budget (bulk scoring, evals,
distillation traces).  Results land in a :class:`JSONLResultSink` — an
append-only JSONL file that doubles as the job's CHECKPOINT: token
deltas append as they are delivered (write-behind, bounded flush), so a
preempted or killed run resumes from the delivered prefix via the
delivered-token resume discipline (docs/ROBUSTNESS.md "Stream failover
semantics") instead of re-decoding — zero re-decode of delivered
tokens, bit-exact for greedy and device-sampled jobs.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


class BatchJob:
    """One offline job: ``prompts`` (each a sequence of token ids) that
    share ``steps`` and one sampling config.  ``resumable`` jobs (greedy
    or device-sampled — (seed, position)-keyed streams) continue
    bit-exact from delivered tokens after a kill; host-sampled jobs
    ("host sampling allowed": the lane never streams to a human) restart
    interrupted items from scratch — their PRNG is keyed by draw order,
    which does not survive the restart."""

    def __init__(self, job_id: str, prompts: Sequence[Sequence[int]],
                 steps: int, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: Optional[int] = None,
                 device_sampling: bool = False,
                 stop_tokens: Sequence[int] = (), priority: int = 0,
                 metadata: Optional[dict] = None):
        if not job_id:
            raise ValueError("job_id must be non-empty")
        if not prompts:
            raise ValueError("a batch job needs at least one prompt")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        self.job_id = str(job_id)
        self.prompts: List[np.ndarray] = [
            np.asarray(p, np.int32).reshape(-1) for p in prompts]
        for i, p in enumerate(self.prompts):
            if p.size == 0:
                raise ValueError(f"prompt {i} is empty")
        self.steps = int(steps)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = seed
        self.device_sampling = bool(device_sampling)
        self.stop_tokens = tuple(int(t) for t in stop_tokens)
        #: priority WITHIN the batch class (the engine ranks every online
        #: request above every batch request regardless of this)
        self.priority = int(priority)
        self.metadata = dict(metadata or {})

    def __len__(self) -> int:
        return len(self.prompts)

    @property
    def resumable(self) -> bool:
        """Delivered-token resume is bit-exact only for (seed,
        position)-keyed streams: greedy, or device sampling."""
        return self.temperature <= 0.0 or self.device_sampling

    def sampling(self):
        """The job's :class:`~tpulab_torch.engine.paged.SamplingParams`
        (None = greedy, the engine default)."""
        if self.temperature <= 0.0:
            return None
        from tpulab_torch.engine.paged import SamplingParams
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p,
                              seed=self.seed, device=self.device_sampling)

    # -- manifest (JSON) roundtrip ------------------------------------------
    def to_manifest(self) -> dict:
        return {"job_id": self.job_id,
                "prompts": [[int(t) for t in p] for p in self.prompts],
                "steps": self.steps, "temperature": self.temperature,
                "top_k": self.top_k, "top_p": self.top_p,
                "seed": self.seed,
                "device_sampling": self.device_sampling,
                "stop_tokens": list(self.stop_tokens),
                "priority": self.priority, "metadata": self.metadata}

    @classmethod
    def from_manifest(cls, doc: dict) -> "BatchJob":
        return cls(doc["job_id"], doc["prompts"], doc["steps"],
                   temperature=doc.get("temperature", 0.0),
                   top_k=doc.get("top_k", 0), top_p=doc.get("top_p", 0.0),
                   seed=doc.get("seed"),
                   device_sampling=doc.get("device_sampling", False),
                   stop_tokens=doc.get("stop_tokens", ()),
                   priority=doc.get("priority", 0),
                   metadata=doc.get("metadata"))


class ItemProgress:
    """One job item's recovered state (JSONLResultSink.load_progress)."""

    __slots__ = ("tokens", "done")

    def __init__(self, tokens: Optional[List[int]] = None,
                 done: bool = False):
        self.tokens: List[int] = list(tokens or [])
        self.done = bool(done)


class JSONLResultSink:
    """Append-only JSONL result file that doubles as the job checkpoint.

    Record shapes (one JSON object per line):

    - ``{"job": id, "item": i, "start": N, "tokens": [...]}`` — a token
      DELTA: positions ``N .. N+len-1`` of item ``i``'s generation.
      Deltas append in order; ``start`` makes replayed/overlapping
      flushes idempotent at load.
    - ``{"job": id, "item": i, "done": true, "n": total}`` — the item
      completed with ``total`` tokens.
    - ``{"job": id, "item": i, "reset": true}`` — delivered tokens are
      void (a host-sampled item restarting from scratch: its PRNG draw
      order does not survive); the loader discards everything earlier.

    Appends buffer per item and flush every ``flush_every`` tokens (and
    at done/reset/close), bounding the write amplification of
    token-granular checkpointing; ``flush()`` fsyncs when ``fsync=True``
    (off by default — tests and bench run on tmpfs-class paths).
    Thread-safe: token callbacks arrive on the engine's scheduler
    thread while the batch scheduler marks items done from callbacks.
    """

    def __init__(self, path: str, flush_every: int = 16,
                 fsync: bool = False):
        self.path = str(path)
        self.flush_every = max(1, int(flush_every))
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        #: (job, item) -> [start, [buffered tokens]]
        self._buf: Dict[tuple, list] = {}
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    # -- writes -------------------------------------------------------------
    def _write_locked(self, rec: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())

    def _flush_item_locked(self, key: tuple) -> None:
        entry = self._buf.pop(key, None)
        if not entry or not entry[1]:
            return
        job, item = key
        self._write_locked({"job": job, "item": item, "start": entry[0],
                            "tokens": entry[1]})

    def append_token(self, job_id: str, item: int, index: int,
                     token: int) -> None:
        """One delivered token at absolute position ``index`` of the
        item's generation (checkpoint-as-you-go)."""
        key = (job_id, int(item))
        with self._lock:
            entry = self._buf.get(key)
            if entry is not None and entry[0] + len(entry[1]) != int(index):
                # non-contiguous (an interrupted item restarting): flush
                # what we hold and start a fresh delta at the new start
                self._flush_item_locked(key)
                entry = None
            if entry is None:
                entry = self._buf[key] = [int(index), []]
            entry[1].append(int(token))
            if len(entry[1]) >= self.flush_every:
                self._flush_item_locked(key)

    def mark_done(self, job_id: str, item: int, n_tokens: int) -> None:
        key = (job_id, int(item))
        with self._lock:
            self._flush_item_locked(key)
            self._write_locked({"job": job_id, "item": int(item),
                                "done": True, "n": int(n_tokens)})

    def mark_reset(self, job_id: str, item: int) -> None:
        """Void an item's delivered tokens (host-sampled restart)."""
        key = (job_id, int(item))
        with self._lock:
            self._buf.pop(key, None)
            self._write_locked({"job": job_id, "item": int(item),
                                "reset": True})

    def flush(self) -> None:
        """Land every buffered delta (run interruption, shutdown)."""
        with self._lock:
            for key in list(self._buf):
                self._flush_item_locked(key)

    # -- recovery -----------------------------------------------------------
    def load_progress(self, job_id: str) -> Dict[int, ItemProgress]:
        """Recover per-item state from the file: delivered tokens (in
        order, duplicates from overlapping flushes dropped via
        ``start``) and done flags.  Unparseable trailing garbage (a
        torn final write from a kill) is skipped — everything durable
        before it survives."""
        out: Dict[int, ItemProgress] = {}
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn write: keep what landed before it
                if rec.get("job") != job_id:
                    continue
                item = int(rec.get("item", -1))
                if item < 0:
                    continue
                p = out.setdefault(item, ItemProgress())
                if rec.get("reset"):
                    p.tokens = []
                    p.done = False
                elif rec.get("done"):
                    p.done = True
                elif "tokens" in rec:
                    start = int(rec.get("start", len(p.tokens)))
                    toks = [int(t) for t in rec["tokens"]]
                    if start > len(p.tokens):
                        continue  # gap (lost delta): keep the prefix only
                    # overlap from a replayed flush: drop the duplicate
                    # prefix, append the genuinely new suffix
                    p.tokens.extend(toks[len(p.tokens) - start:])
        return out
