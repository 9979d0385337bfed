"""FleetObserver: telemetry federation — one fleet view, one timeline
(the port of ``tpulab/fleet/observer.py``; tpulab's document, plus each
replica's ``kernels`` section from the port's Debug snapshot).

Every observability surface below this module is replica-scoped: a
replica's /metrics registries, its debugz document, its flight-recorder
rings, its Chrome trace.  At fleet scale the operator's questions span
replicas — "which replica is out of HBM headroom?", "did the autoscaler
flap because ONE replica queued?", "show me this request's timeline
across the router and the replica that served it" — so this module
assembles the fleet-scope views from the per-replica surfaces that
already exist, over the same Status/Debug RPCs the routers ride:

- :meth:`FleetObserver.fleetz` — ONE snapshot document: per-replica
  lanes / HBM headroom / model residency / prefix hits / inflight /
  drain state (Status + Debug RPCs) next to the control plane's own
  state (the FleetController's election/supervisor/autoscaler snapshot)
  and the per-tenant SLO burn document.
- a **federated /metrics view**: each fleetz scrape refreshes the
  replica-labeled ``_fed_*`` gauges
  (:class:`~tpulab_torch.utils.metrics.FederationMetrics`); hang the
  observer's metrics next to the router's collectors behind one port
  via the existing
  :class:`~tpulab_torch.utils.metrics.MultiRegistryCollector`
  discipline.
- **artifact collection**: :meth:`merge_traces` rebases per-replica
  Chrome traces (the evidence-on-exit dumps
  ``tpulab_torch.fleet.replica_main`` autosaves) onto one wall-clock timeline
  via :func:`~tpulab_torch.utils.tracing.merge_chrome_traces`, and
  :meth:`collect_flight` merges per-replica flight-recorder JSONL dumps
  into one wall-clock-ordered exemplar stream (torn-trailing-write
  tolerant, like every JSONL reader in this repo).

The observer is read-only and crash-tolerant: a replica that fails its
RPC appears in the snapshot with its error, never takes the scrape
down.  See docs/OBSERVABILITY.md "Fleet observability".
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Dict, List

log = logging.getLogger("tpulab_torch.fleet")

__all__ = ["FleetObserver"]


class FleetObserver:
    """Module docstring.  ``replica_set`` supplies membership (the
    ``_BaseReplicaSet`` surface); ``controller`` an optional
    :class:`~tpulab_torch.fleet.control.FleetController` whose snapshot rides
    along; ``slo`` an optional :class:`~tpulab_torch.obs.slo.SLOTracker`
    (each fleetz refreshes its burn gauges); ``metrics`` an optional
    :class:`~tpulab_torch.utils.metrics.FederationMetrics`."""

    def __init__(self, replica_set, controller=None, slo=None,
                 metrics=None, timeout_s: float = 5.0,
                 channels: int = 1):
        self._rs = replica_set
        self._controller = controller
        self._slo = slo
        self._metrics = metrics
        self.timeout_s = float(timeout_s)
        self._channels = int(channels)
        self._lock = threading.Lock()
        self._clients: Dict[str, Any] = {}  # addr -> RemoteInferenceManager
        #: lifetime counters
        self.scrapes = 0
        self.scrape_errors = 0

    # -- clients --------------------------------------------------------------
    def _client(self, address: str):
        from tpulab_torch.rpc.infer_service import RemoteInferenceManager
        with self._lock:
            cli = self._clients.get(address)
            if cli is None:
                cli = RemoteInferenceManager(address,
                                             channels=self._channels)
                self._clients[address] = cli
            return cli

    def _drop_client(self, address: str) -> None:
        with self._lock:
            cli = self._clients.pop(address, None)
        if cli is not None:
            try:
                cli.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass

    def _addresses(self) -> List[str]:
        """Every non-retired member (active AND draining — a draining
        replica still serves its in-flight work and still matters)."""
        states = self._rs.breaker_states()
        return [a for a, s in states.items() if s != "retired"]

    # -- the snapshot ---------------------------------------------------------
    def fleetz(self, include_debug: bool = True) -> Dict[str, Any]:
        """Assemble ONE fleet snapshot: per-replica Status (load/
        headroom/residency/prefix/drain) — plus a Debug-RPC summary
        (lanes, flight exemplars) when ``include_debug`` — next to the
        control plane's own snapshot and the SLO burn document.
        Refreshes the federated ``_fed_*`` gauges when armed."""
        t0 = time.perf_counter()
        addrs = self._addresses()
        # fan the Status RPCs out before collecting any (the scrape
        # costs one slowest-replica RTT, not the sum)
        futs: Dict[str, Any] = {}
        replicas: Dict[str, Dict[str, Any]] = {}
        for addr in addrs:
            try:
                futs[addr] = self._client(addr).server_status_async()
            except Exception as e:  # noqa: BLE001 - a dead replica is data
                replicas[addr] = {"up": False,
                                  "error": f"{type(e).__name__}: {e}"}
        for addr, fut in futs.items():
            try:
                resp = fut.result(timeout=self.timeout_s)
                replicas[addr] = {
                    "up": True,
                    "role": str(getattr(resp, "role", "") or ""),
                    "inflight": int(getattr(resp, "inflight_requests",
                                            0) or 0),
                    "queued": int(resp.queued_requests),
                    "free_kv_pages": int(resp.free_kv_pages),
                    "free_hbm_bytes": int(getattr(resp, "free_hbm_bytes",
                                                  0) or 0),
                    "resident_models": [str(m) for m in
                                        getattr(resp, "resident_models",
                                                ())],
                    "host_models": [str(m) for m in
                                    getattr(resp, "host_models", ())],
                    "prefix_hits": int(getattr(resp, "prefix_hits", 0)
                                       or 0),
                    "prefix_lookups": int(getattr(resp, "prefix_lookups",
                                                  0) or 0),
                    "draining": bool(getattr(resp, "draining", False)),
                }
            except Exception as e:  # noqa: BLE001 - dead replica is data
                self.scrape_errors += 1
                replicas[addr] = {"up": False,
                                  "error": f"{type(e).__name__}: {e}"}
                self._drop_client(addr)
        if include_debug:
            for addr, doc in replicas.items():
                if not doc.get("up"):
                    continue
                try:
                    snap = self._client(addr).debugz(
                        timeout=self.timeout_s)
                    doc["lanes"] = self._lanes_of(snap)
                    flight = snap.get("flight") or {}
                    doc["flight_exemplars"] = flight.get("exemplar_ids",
                                                         [])
                    # the port's own section: the replica's kernel
                    # launch counters (Debug ``kernels``)
                    if "kernels" in snap:
                        doc["kernels"] = snap["kernels"]
                except Exception as e:  # noqa: BLE001
                    doc["debug_error"] = f"{type(e).__name__}: {e}"
        out: Dict[str, Any] = {
            "wall_time": time.time(),
            "replicas": replicas,
            # the observing router's own view of the same members —
            # breaker health and last load hints next to what the
            # replicas self-report
            "breaker_states": self._rs.breaker_states(),
            "load_hints": self._rs.load_hints(),
        }
        if self._controller is not None:
            try:
                out["control"] = self._controller.snapshot()
            except Exception as e:  # noqa: BLE001
                out["control"] = {"error": f"{type(e).__name__}: {e}"}
        if self._slo is not None:
            try:
                out["slo"] = self._slo.snapshot()
                self._slo.export()  # refresh the _slo_* burn gauges
            except Exception as e:  # noqa: BLE001
                out["slo"] = {"error": f"{type(e).__name__}: {e}"}
        self.scrapes += 1
        elapsed = time.perf_counter() - t0
        out["scrape_s"] = round(elapsed, 6)
        m = self._metrics
        if m is not None:
            for addr, doc in replicas.items():
                m.set_replica(
                    addr, up=bool(doc.get("up")),
                    inflight=doc.get("inflight", 0),
                    queued=doc.get("queued", 0),
                    free_hbm_bytes=doc.get("free_hbm_bytes", 0),
                    free_kv_pages=doc.get("free_kv_pages", 0),
                    draining=bool(doc.get("draining", False)),
                    prefix_hits=doc.get("prefix_hits", 0),
                    prefix_lookups=doc.get("prefix_lookups", 0),
                    resident_models=len(doc.get("resident_models", ())))
            m.prune(replicas.keys())
            m.observe_scrape(elapsed, len(replicas))
        return out

    @staticmethod
    def _lanes_of(debug_doc: Dict[str, Any]) -> Dict[str, int]:
        """Per-model busy-lane counts out of a debugz document (engines
        report ``lanes`` as a list of lane records)."""
        lanes: Dict[str, int] = {}
        for name, eng in (debug_doc.get("engines") or {}).items():
            v = eng.get("lanes") if isinstance(eng, dict) else None
            if isinstance(v, list):
                lanes[name] = len(v)
            elif isinstance(v, (int, float)):
                lanes[name] = int(v)
        return lanes

    # -- artifact collection --------------------------------------------------
    @staticmethod
    def merge_traces(out_path: str, *paths: str) -> str:
        """Merge per-replica Chrome traces (each epoch-anchored by its
        own recorder) onto one rebased wall-clock timeline — the
        cross-process request story, one file for ui.perfetto.dev."""
        from tpulab_torch.utils.tracing import merge_chrome_traces
        return merge_chrome_traces(out_path, *paths)

    @staticmethod
    def collect_flight(*paths: str) -> List[Dict[str, Any]]:
        """Merge per-replica flight-recorder JSONL dumps (the
        evidence-on-exit artifacts) into one wall-clock-ordered record
        list.  Missing files and torn trailing lines are skipped — a
        SIGKILLed replica's dump still reads to its last durable
        record.  Each record gains ``source`` (its dump path)."""
        records: List[Dict[str, Any]] = []
        for path in paths:
            try:
                f = open(path, "r", encoding="utf-8")
            except OSError:
                continue
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn trailing write
                    if isinstance(rec, dict):
                        rec.setdefault("source", path)
                        records.append(rec)
        records.sort(key=lambda r: r.get("wall_time", 0.0))
        return records

    def close(self) -> None:
        with self._lock:
            clients, self._clients = dict(self._clients), {}
        for cli in clients.values():
            try:
                cli.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
