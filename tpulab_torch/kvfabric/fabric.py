"""Fleet KV fabric: digest-keyed fleet-wide prefix-KV lookup (the port
of ``tpulab/kvfabric/fabric.py``; tpulab's protocol, wire blob and
guard rails).

Prefix-affinity routing (tpulab_torch.fleet) makes the fleet behave like one
large prefix cache — until it can't: a spilled request (home replica too
hot), a membership change, or a plain load_pick fallback lands a prompt
on a replica whose caches are cold while the digest's HOME replica holds
the finished prefill a page-table hop away.  Pre-fabric, the serving
replica recomputes the whole prompt.  This module closes that gap with a
PULL: on a local prefix-cache/host-tier miss, the serving replica asks
the digest's home — the SAME rank-0 member the router's HRW ordering
names (:meth:`~tpulab_torch.fleet.router.PrefixAffinityRouter.ranked`),
so
there is no directory service to keep consistent — for the prefix KV via
the ``FetchKV`` RPC, admits the returned wire snapshot through the
existing shipped-KV path (:meth:`~tpulab_torch.kvcache.offload.
KVOffloadManager.adopt` + ``ContinuousBatcher.submit_shipped``), and
decodes with ZERO local prefill dispatches.

Identity is CONTENT, not placement: the fetch keys on the full-prompt
``prompt_digest`` (tpulab_torch.disagg.wire) — exact-prompt matches only
(partial-prefix pulls are a ROADMAP follow-up) — while home RESOLUTION
keys on the router's 32-token affinity digest, because "home" must mean
exactly what the router meant when it routed the original request there.

First-token parity: the owner publishes the prefill's last-position
logits row beside the snapshot (wire header extras), and the FETCHER
picks the first token under its OWN sampling — argmax for greedy,
:func:`~tpulab_torch.engine.prng.device_sample_tokens` (the single
device-sampling stream definition, ``jax.random``'s threefry bit for
bit) on the fetcher's device for device-sampled requests — so the token
stream is bit-exact against a local prefill on either side.
Host-sampled and logprob-streaming requests never pull (same rule as
disagg shipments: their host PRNG / per-tick logits don't survive the
replica hop).

Guard rails, every one degrading to the pre-fabric local prefill:

- **Cost gate** — a pull is only worth it when shipping the bytes beats
  recomputing the tokens: estimated fetch time (page bytes / observed
  fetch-throughput EWMA) must not exceed estimated prefill time (tokens
  / the engine's ``prefill_ewma_tok_s``).  Optimistic until both EWMAs
  exist (the first pulls are also the measurement).
- **Single-flight** — N concurrent misses on one digest issue exactly
  ONE FetchKV; waiters share the deserialized snapshot and each adopts
  its own host-tier copy (restore POPS its entry, so copies cannot be
  shared).
- **Bounded staleness** — the owner answers NOT_FOUND honestly (entry
  still in write-behind flight, evicted, or never published); the
  fabric never blocks on an owner's internal fences.
- **Chaos** — the ``fabric.pull`` trip point (docs/ROBUSTNESS.md) fires
  on BOTH sides: the owner's export and the fetcher's pull each degrade
  to "no shipment" on error or drop.
"""

from __future__ import annotations

import base64
import logging
import threading
import time as _time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tpulab_torch import chaos
from tpulab_torch.disagg.wire import (WireFormatError, deserialize_snapshot,
                                      prompt_digest, serialize_snapshot)
from tpulab_torch.fleet.router import prefix_digest

log = logging.getLogger("tpulab_torch.kvfabric")

#: wire-header extras key carrying the owner's prefill last-position
#: logits row (f32, base64) — the fetcher's first-token sampling input
LOGITS_EXTRA = "prefill_logits_f32_b64"


def fabric_export(engine, digest: bytes) -> Optional[bytes]:
    """Owner side of one FetchKV: wire-encode the published snapshot for
    ``digest`` from ``engine``'s host tier WITHOUT consuming it — the
    read goes through :meth:`~tpulab_torch.kvcache.host_store.
    HostKVStore.peek` (no LRU touch: remote popularity must not evict the
    owner's own working set) and the store keeps its copy, unlike the
    disagg export's pop.  None = honest miss (not published, still in
    write-behind flight, evicted, chaos-tripped) — the fetcher degrades
    to a local prefill."""
    mgr = getattr(engine, "kv_offload", None)
    if mgr is None or not getattr(engine, "kv_publish", False):
        return None
    try:
        if chaos.trip("fabric.pull") == "drop":
            raise chaos.ChaosError("injected fabric export drop")
        handle = engine.fab_handle(digest)
        if handle is None:
            return None
        arr = mgr.store.peek(handle.key)
        logits = mgr.store.peek(("fablog", digest))
        if arr is None or logits is None:
            # bounded staleness: publish still in flight or evicted —
            # answer honestly rather than wait out the owner's fences
            return None
        row = logits.to(torch.float32).reshape(-1).contiguous()
        return serialize_snapshot(
            arr, digest=digest, length=handle.length,
            page_size=mgr.pool.page_size,
            first_token=int(torch.argmax(row)),
            extras={LOGITS_EXTRA: base64.b64encode(
                row.numpy().tobytes()).decode("ascii")})
    except Exception as e:  # noqa: BLE001 - degrade, never corrupt
        log.warning("fabric export degraded (fetcher will prefill "
                    "locally): %s: %s", type(e).__name__, str(e)[:200])
        return None


class PulledKV:
    """One adopted fabric pull, ready for ``submit_shipped``."""

    __slots__ = ("handle", "digest", "length", "first_token", "nbytes",
                 "coalesced")

    def __init__(self, handle, digest: bytes, length: int,
                 first_token: int, nbytes: int, coalesced: bool):
        self.handle = handle
        self.digest = digest
        self.length = length
        self.first_token = first_token
        self.nbytes = nbytes
        #: True when this pull shared a single-flight leader's fetch
        self.coalesced = coalesced


class _Flight:
    __slots__ = ("done", "result")

    def __init__(self):
        self.done = threading.Event()
        self.result = None  # (arr, header, nbytes) | None


class KVFabric:
    """Fetcher-side fabric state for one serving replica (module
    docstring).

    ``self_key`` is this replica's member key exactly as the fleet
    router scores it; ``members`` the live fleet membership (an iterable
    or a zero-arg callable returning one — the serving layer hands in
    whatever tracks its fleet view); ``connect`` maps a member key to a
    client exposing ``fetch_kv(model_name, digest) -> Optional[bytes]``
    (clients are cached; ``close`` closes them).  ``router`` supplies
    the ONE HRW ordering (:meth:`ranked`) — the fabric never re-derives
    it.  Thread-safe: RPC worker threads pull concurrently."""

    #: bound on a single-flight waiter sharing a leader's fetch
    FETCH_WAIT_S = 30.0
    #: prompts shorter than this never pull (wire overhead dwarfs the
    #: saved prefill even before the cost gate has data)
    MIN_PROMPT_TOKENS = 2

    def __init__(self, self_key: str, members, connect: Callable[[str], Any],
                 router, *, cost_gate: bool = True, metrics=None):
        self.self_key = str(self_key)
        self._members = members if callable(members) else (lambda: members)
        self._connect = connect
        self.router = router
        self.cost_gate = bool(cost_gate)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._clients: Dict[str, Any] = {}
        self._flights: Dict[bytes, _Flight] = {}
        self._seq = 0
        #: observed fetch throughput (bytes/s, EWMA over completed
        #: FetchKV RPCs) — the cost gate's wire-time estimate
        self.fetch_bytes_per_s = 0.0
        # -- counters (KVFabricMetrics.poll advances from these) ------------
        self.pulls = 0                   # FetchKV fetches adopted locally
        self.pull_bytes = 0              # wire bytes fetched
        self.coalesced = 0               # waiters served by another's fetch
        self.cost_gate_skips = 0         # pulls skipped as dearer than
        #                                  recomputing
        self.degrades = 0                # pull attempts fallen back to
        #                                  local prefill (any cause)
        self.recompute_tokens_saved = 0  # prefill tokens pulls skipped

    # -- home resolution ------------------------------------------------------
    def home_of(self, prompt) -> Optional[str]:
        """The digest's home member key, or None when this replica IS
        the home (local state is authoritative — nothing to pull) or the
        fleet is effectively a singleton.  Keys off the router's
        AFFINITY digest, not the content digest: "home" must mean what
        the router meant when it placed the original request."""
        ms = sorted(self._members())
        if len(ms) < 2:
            return None
        rd = prefix_digest(prompt, self.router.affinity_tokens)
        home = self.router.ranked(rd, ms)[0]
        return None if home == self.self_key else home

    # -- eligibility / admission cost -----------------------------------------
    def would_pull(self, prompt, sampling, engine,
                   logprobs: bool = False) -> Optional[str]:
        """Cheap, side-effect-free pull eligibility check (admission's
        PROMOTE-cost estimate and ``pull``'s own precondition): the home
        member key when a pull WOULD be attempted, else None.  No chaos,
        no counters, no RPC — callable from the admission path."""
        if engine is None or getattr(engine, "kv_offload", None) is None:
            return None
        prompt = np.asarray(prompt).reshape(-1)
        if len(prompt) < self.MIN_PROMPT_TOKENS:
            return None
        if logprobs:
            return None
        sp = sampling
        if sp is not None and sp.temperature > 0.0 and not sp.device:
            return None  # host PRNG streams don't survive the hop
        pc = getattr(engine, "prefix_cache", None)
        if pc is not None:
            cacheable = max(0, (len(prompt) - 1) // engine.page_size)
            if cacheable and pc.coverage(prompt,
                                         engine.page_size) >= cacheable:
                return None  # local prefill is already ~a tail extend
        return self.home_of(prompt)

    def _gate_skips(self, n_prompt: int, engine) -> bool:
        """True when the cost gate says recomputing is CHEAPER than
        fetching (both EWMAs known; optimistic otherwise — the first
        pulls are also the measurement)."""
        if not self.cost_gate:
            return False
        bps = self.fetch_bytes_per_s
        tps = float(getattr(engine, "prefill_ewma_tok_s", 0.0) or 0.0)
        if bps <= 0.0 or tps <= 0.0:
            return False
        n_pages = -(-n_prompt // engine.page_size)
        est_fetch_s = n_pages * engine.kv_offload.page_nbytes / bps
        est_prefill_s = n_prompt / tps
        return est_fetch_s > est_prefill_s

    # -- the pull -------------------------------------------------------------
    def pull(self, prompt, sampling, engine, shipper,
             model_name: str = "") -> Optional[PulledKV]:
        """Attempt one fabric pull for ``prompt``.  Returns the adopted
        :class:`PulledKV` (feed it to ``submit_shipped``), or None —
        EVERY None means "prefill locally", never an error surfaced to
        the request.  ``shipper`` is the engine's
        :class:`~tpulab_torch.disagg.KVShipper` (geometry gate + adopt
        manager); callers must ``shipper.manager.discard`` the handle if
        the engine then rejects the admission."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        home = self.would_pull(prompt, sampling, engine)
        if home is None:
            return None
        n_prompt = len(prompt)
        if self._gate_skips(n_prompt, engine):
            with self._lock:
                self.cost_gate_skips += 1
            return None
        digest = prompt_digest(prompt)
        try:
            if chaos.trip("fabric.pull") == "drop":
                raise chaos.ChaosError("injected fabric pull drop")
            res, coalesced = self._single_flight(home, digest, model_name,
                                                 engine)
            if res is None:
                raise WireFormatError("no fabric shipment")
            arr, header, nbytes = res
            first_token = self._first_token(
                header, sampling, getattr(engine, "device", None))
            with self._lock:
                self._seq += 1
                key = ("fabin", self._seq)
            handle = shipper.manager.adopt(key, arr,
                                           int(header["length"]))
            if handle is None:  # budget refused (counted as swap_drop)
                raise WireFormatError("host tier refused the pull")
        except Exception as e:  # noqa: BLE001 - degrade, never corrupt
            with self._lock:
                self.degrades += 1
            log.warning("fabric pull degraded to local prefill: %s: %s",
                        type(e).__name__, str(e)[:200])
            return None
        with self._lock:
            self.pulls += 1
            self.recompute_tokens_saved += int(header["length"])
        return PulledKV(handle, digest, int(header["length"]),
                        first_token, nbytes, coalesced)

    def note_degrade(self, pulled: Optional[PulledKV] = None) -> None:
        """Count a degrade that happened AFTER a successful pull — the
        engine rejected the admission and the caller discarded the
        handle: the fetched prefix recomputes after all, so its tokens
        come back OFF the saved ledger."""
        with self._lock:
            self.degrades += 1
            if pulled is not None:
                self.recompute_tokens_saved -= int(pulled.length)

    def _single_flight(self, home: str, digest: bytes, model_name: str,
                       engine):
        """One FetchKV per digest no matter how many threads miss at
        once: the first becomes the leader and fetches; the rest wait
        and share the leader's deserialized snapshot (each caller still
        adopts its OWN host-tier copy — restore pops).  Returns
        ``(result, coalesced)``."""
        with self._lock:
            fl = self._flights.get(digest)
            if fl is not None:
                self.coalesced += 1
                leader = False
            else:
                fl = _Flight()
                self._flights[digest] = fl
                leader = True
        if not leader:
            if not fl.done.wait(self.FETCH_WAIT_S):
                return None, True
            return fl.result, True
        try:
            fl.result = self._fetch(home, digest, model_name, engine)
        finally:
            with self._lock:
                self._flights.pop(digest, None)
            fl.done.set()
        return fl.result, False

    def _fetch(self, home: str, digest: bytes, model_name: str, engine):
        """The leader's wire fetch: RPC, decode, geometry-gate.  None on
        any failure (the whole flight degrades)."""
        t0 = _time.perf_counter()
        try:
            client = self._client(home)
            blob = client.fetch_kv(model_name, digest)
            if not blob:
                return None  # honest NOT_FOUND (or transport degrade)
            arr, header = deserialize_snapshot(blob)
            self._check_geometry(engine, arr, header)
        except Exception as e:  # noqa: BLE001 - degrade, never corrupt
            log.warning("fabric fetch from %s failed: %s: %s", home,
                        type(e).__name__, str(e)[:200])
            return None
        dt = max(1e-9, _time.perf_counter() - t0)
        inst = len(blob) / dt
        with self._lock:
            self.pull_bytes += len(blob)
            self.fetch_bytes_per_s = (
                inst if self.fetch_bytes_per_s == 0.0
                else 0.7 * self.fetch_bytes_per_s + 0.3 * inst)
        if self.metrics is not None:
            self.metrics.observe_pull(dt, len(blob))
        return arr, header, len(blob)

    @staticmethod
    def _check_geometry(engine, arr: torch.Tensor, header: dict) -> None:
        """The same reject-don't-corrupt gate a disagg import runs
        (:meth:`~tpulab_torch.disagg.KVShipper.check_geometry`), reached
        through the engine's shipper-independent manager."""
        from tpulab_torch.disagg.shipper import KVShipper
        KVShipper(engine.kv_offload).check_geometry(arr, header)

    def _first_token(self, header: dict, sampling, device=None) -> int:
        """The fetcher-side first-token pick: argmax (the owner's
        ``first_token`` header field) for greedy, the single
        device-sampling stream replayed on the shipped logits row for
        device-sampled requests — bit-exact against the local prefill
        that was skipped.  ``device`` is where the replay runs (the
        fetching engine's device: the local prefill it replaces samples
        there); None = the CPU."""
        sp = sampling
        if sp is None or sp.temperature <= 0.0:
            return int(header["first_token"])
        b64 = header.get(LOGITS_EXTRA)
        if not b64:
            raise WireFormatError(
                "shipment carries no prefill logits (device-sampled "
                "pulls need them for first-token parity)")
        from tpulab_torch.engine.prng import device_sample_tokens
        dev = torch.device(device) if device is not None else None
        row = torch.frombuffer(bytearray(base64.b64decode(b64)),
                               dtype=torch.float32).to(dev)
        pos = int(header["length"]) - 1
        return int(device_sample_tokens(
            row[None], torch.tensor([sp.temperature], device=dev),
            torch.tensor([[sp.seed & 0xFFFFFFFF,
                           (sp.seed >> 32) & 0xFFFFFFFF]], device=dev),
            torch.tensor([pos], device=dev))[0])

    # -- plumbing -------------------------------------------------------------
    def _client(self, member: str):
        with self._lock:
            c = self._clients.get(member)
        if c is not None:
            return c
        c = self._connect(member)
        with self._lock:
            # two threads may have connected concurrently: keep the first
            incumbent = self._clients.setdefault(member, c)
        if incumbent is not c and hasattr(c, "close"):
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        return incumbent

    def snapshot(self) -> Dict[str, Any]:
        """Counters for tests/debugz."""
        with self._lock:
            return {"pulls": self.pulls, "pull_bytes": self.pull_bytes,
                    "coalesced": self.coalesced,
                    "cost_gate_skips": self.cost_gate_skips,
                    "degrades": self.degrades,
                    "recompute_tokens_saved": self.recompute_tokens_saved,
                    "fetch_bytes_per_s": self.fetch_bytes_per_s}

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            if hasattr(c, "close"):
                try:
                    c.close()
                except Exception:  # noqa: BLE001
                    pass
