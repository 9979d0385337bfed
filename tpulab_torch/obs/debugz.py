"""Debugz: the live "what is the engine holding RIGHT NOW" snapshot (the
port of ``tpulab/obs/debugz.py``; tpulab's document).

Metrics are rates and distributions; traces are the past; this is the
present tense — the view an operator pulls when a replica looks wedged:
which requests occupy which batcher lanes (and for how long), where the
elastic pool sits on its size ladder, who holds the HBM ledger's bytes
(and whether the ledger still agrees with the allocator gauges), which
models are resident and how many leases pin them, how deep each tenant's
admission queue runs, what chaos is armed, and which flight-recorder
exemplars to read next.

Served over the ``Debug`` unary RPC (``RemoteInferenceManager.debugz``)
as ONE JSON document (``DebugResponse.snapshot_json``).  Layout (every
section optional — a replica reports the subsystems it runs):

    {"wall_time": ..., "server_version": ...,
     "engines": {name: {"lanes": [...], "queue_head": [...],
                        "pool": {...}, "dispatch": {...}, "spec": {...},
                        "prefix_cache": {...}}},
     "admission": {"inflight", "queue_depth", "queue_depths_by_tenant",
                   "model_inflight", "admitted_total", ...},
     "hbm": {"capacity_bytes", "free_hbm_bytes", "claims": [...],
             "reservations": [...], "verify_mismatches": {...}, ...},
     "modelstore": {"resident", "host", "leases": {...}},
     "chaos": {"armed", "rules", "fired", "seen"},
     "watchdog": {...},
     "flight": {"retained", "dropped", "kept_by_reason",
                "exemplar_ids", "assembly_ms_p99"}}

tpulab's ``fleet`` section (the control plane's election, supervision
and autoscaling) comes with the fleet (ROADMAP queue 1, item 5).

On-demand profiling: ``profile_ticks=N`` on the Debug RPC arms
``torch.profiler`` around the next N scheduler passes of the selected
engine (:meth:`~tpulab_torch.engine.paged.ContinuousBatcher.arm_profile`)
and the response returns the trace directory.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

__all__ = ["debug_snapshot"]


def _engine_section(engine) -> Dict[str, Any]:
    """One generation engine's live state; engines without the batcher's
    introspection surface report what they expose."""
    state = getattr(engine, "debug_state", None)
    if callable(state):
        return state()
    out: Dict[str, Any] = {"kind": type(engine).__name__}
    for attr in ("queued_requests", "active_lanes", "vocab", "max_len"):
        v = getattr(engine, attr, None)
        if v is not None:
            try:
                out[attr] = int(v)
            except Exception:
                pass
    return out


def debug_snapshot(resources=None, *, generation_engines=None,
                   admission=None, hbm=None, modelstore=None,
                   flight=None, watchdog=None,
                   model_name: str = "") -> Dict[str, Any]:
    """Assemble the live snapshot (module docstring layout).

    Pass an :class:`~tpulab_torch.rpc.infer_service.InferResources` (the
    Debug RPC does) or the subsystems explicitly (engine-level use: tests,
    bench, a REPL poking a live process).  ``model_name`` focuses the
    engines section on one engine; unknown names report an empty engines
    map (the RPC layer turns that into UNKNOWN_MODEL)."""
    if resources is not None:
        generation_engines = (generation_engines
                              or getattr(resources, "generation_engines",
                                         None))
        admission = admission or getattr(resources, "admission", None)
        hbm = hbm or getattr(resources, "hbm", None)
        modelstore = modelstore or getattr(resources, "modelstore", None)
        flight = flight or getattr(resources, "flight", None)
        watchdog = watchdog or getattr(resources, "watchdog", None)
    snap: Dict[str, Any] = {"wall_time": time.time()}

    engines = {}
    for name, eng in (generation_engines or {}).items():
        if model_name and name != model_name:
            continue
        try:
            engines[name] = _engine_section(eng)
        except Exception as e:  # a torn-down engine must not kill debugz
            engines[name] = {"error": f"{type(e).__name__}: {e}"}
    snap["engines"] = engines

    if admission is not None:
        try:
            snap["admission"] = {
                "inflight": admission.inflight,
                "queue_depth": admission.queue_depth,
                # offline batch lane: its waiters ride their own queue
                # (never an online queue slot) — reported separately,
                # and batch tenants appear as "batch:<tenant>" below
                "batch_queue_depth": getattr(admission,
                                             "batch_queue_depth", 0),
                "batch_admitted_total": getattr(admission,
                                                "batch_admitted_total", 0),
                "queue_depths_by_tenant": admission.queue_depths(),
                "model_inflight": dict(admission.model_inflight),
                "admitted_total": admission.admitted_total,
                "rejected_total": admission.rejected_total,
                "rejected_by_reason": dict(admission.rejected_by_reason),
                "shed_total": admission.shed_total,
                "peak_queue_depth": admission.peak_queue_depth,
            }
        except Exception as e:
            snap["admission"] = {"error": f"{type(e).__name__}: {e}"}

    if hbm is not None:
        try:
            ledger = hbm.ledger
            snap["hbm"] = {
                "capacity_bytes": int(hbm.capacity_bytes),
                "free_hbm_bytes": int(hbm.free_hbm_bytes),
                # claims serialize as [tenant, str(tag), bytes] — tags
                # are hashables (tuples), JSON wants strings
                "claims": [[t, str(tag), int(n)]
                           for t, tag, n in ledger.claims()],
                "reservations": hbm.reservations(),
                # the honesty check debugz exists to surface: {} = the
                # ledger agrees byte-for-byte with every live gauge
                "verify_mismatches": {t: [int(c), int(g)]
                                      for t, (c, g) in
                                      hbm.verify().items()},
                "pressure_events": hbm.pressure_events,
                "grants": hbm.grants,
                "denials": hbm.denials,
                "demotions_forced": hbm.demotions_forced,
                "evictions_forced": hbm.evictions_forced,
            }
        except Exception as e:
            snap["hbm"] = {"error": f"{type(e).__name__}: {e}"}

    if modelstore is not None:
        try:
            snap["modelstore"] = {
                "resident": modelstore.resident_models(),
                "host": modelstore.host_models(),
                "leases": modelstore.lease_counts(),
            }
        except Exception as e:
            snap["modelstore"] = {"error": f"{type(e).__name__}: {e}"}

    from tpulab_torch import chaos
    sched = chaos.armed()
    snap["chaos"] = {"armed": sched is not None}
    if sched is not None:
        snap["chaos"].update({
            "rules": [repr(r) for r in sched.rules],
            "seed": sched.seed,
            "fired": sched.fired_snapshot(),
            "seen": sched.seen_snapshot(),
        })

    if watchdog is not None:
        try:
            snap["watchdog"] = {"healthy": bool(watchdog.healthy)}
        except Exception:
            pass

    if flight is not None:
        aq = flight.assembly_quantiles()
        snap["flight"] = {
            "retained": len(flight),
            "observed_total": flight.observed_total,
            "dropped_total": flight.dropped_total,
            "kept_by_reason": dict(flight.kept_by_reason),
            "exemplar_ids": flight.exemplar_ids(),
            "assembly_ms_p50": round(aq["p50"] * 1e3, 4),
            "assembly_ms_p99": round(aq["p99"] * 1e3, 4),
        }
    return snap


def arm_profile(generation_engines: Optional[Dict[str, Any]],
                model_name: str, ticks: int,
                log_dir: str = "") -> str:
    """Arm a ``torch.profiler`` capture around the next ``ticks``
    scheduler passes of the selected engine (``model_name`` empty = the first
    profile-capable engine).  Returns the trace directory; raises
    KeyError when no engine can capture."""
    for name, eng in (generation_engines or {}).items():
        if model_name and name != model_name:
            continue
        armer = getattr(eng, "arm_profile", None)
        if callable(armer):
            return armer(int(ticks), log_dir or None)
    raise KeyError(model_name or "<any>")
