"""Control-plane event journal: every fleet decision, durably, in order
(the port of ``tpulab/obs/journal.py``; records and replays are tpulab's).

Metrics count WHAT the control plane did; the journal records WHY, with
the evidence, in a form that survives the process that wrote it.  Every
supervisor classification (death with its evidence — exit code vs probe
streak — respawn, backoff, quarantine), every election transition
(acquire/lost/resign/fenced, stamped with the fencing token), and every
autoscaler decision (scale up/down with the queue-wait/overload/SLO-burn
evidence, drain start/complete/timeout) appends ONE structured JSONL
event.  "Why did the fleet do that?" is then a grep over one file, after
any crash — including the crash of the node that wrote it.

Durability model (the tpulab_torch.batch.job JSONL sink's, shared):

- **append-only**: events are one ``json.dumps`` line each, written with
  a single ``write()`` + ``flush()`` under a lock.  A crash mid-append
  can tear at most the TRAILING line.
- **torn-write-tolerant replay**: :func:`replay_journal` skips unparsable
  lines (``except ValueError: continue``) — the same leniency the batch
  checkpoint loader applies — so a journal torn by SIGKILL replays
  cleanly up to the last durable event.
- **monotonic per-writer sequence**: every event carries ``seq`` (and
  the writing ``node``); a journal reopened after a crash resumes its
  sequence from the replayed maximum, so one lineage of a control node
  produces one gap-free sequence.  :func:`sequence_gaps` audits it.

This module is deliberately **stdlib-only**: a control process can load
it by path without importing — or paying for — the serving stack.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("tpulab_torch.obs")

__all__ = ["EventJournal", "replay_journal", "sequence_gaps"]


def replay_journal(path: str) -> List[Dict[str, Any]]:
    """Read a journal back as a list of event dicts, in file order.

    Tolerates a missing file (``[]`` — the journal was never armed) and
    torn trailing writes (a line SIGKILL cut mid-``write`` parses as
    garbage and is skipped, like the batch sink's checkpoint loader)."""
    events: List[Dict[str, Any]] = []
    try:
        f = open(path, "r", encoding="utf-8")
    except OSError:
        return events
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn trailing write — replay what is durable
            if isinstance(ev, dict):
                events.append(ev)
    return events


def sequence_gaps(
        events: List[Dict[str, Any]]) -> List[Tuple[str, int, int]]:
    """Audit per-writer sequence continuity: returns ``(node, seen_seq,
    expected_seq)`` for every event whose ``seq`` is not exactly one
    past its node's previous event.  An empty list is the no-loss
    proof the takeover acceptance test asserts."""
    last: Dict[str, int] = {}
    gaps: List[Tuple[str, int, int]] = []
    for ev in events:
        node = str(ev.get("node", ""))
        seq = int(ev.get("seq", 0))
        prev = last.get(node)
        if prev is not None and seq != prev + 1:
            gaps.append((node, seq, prev + 1))
        last[node] = seq
    return gaps


class EventJournal:
    """Crash-safe append-only JSONL event sink (module docstring).

    ``record(kind, **fields)`` stamps ``seq``/``node``/``wall_time`` and
    appends one line; IO failures are swallowed and counted
    (``append_errors``) — the journal observes the control plane, it
    must never take it down.  ``clock`` is injectable for deterministic
    tests; ``fsync=True`` pays one fsync per event for power-loss
    durability (crash durability — the mode every test and the takeover
    acceptance run in — needs only the flush)."""

    def __init__(self, path: str, node: Optional[str] = None,
                 clock=time.time, fsync: bool = False):
        self.path = path
        self.node = node or f"{os.uname().nodename}:{os.getpid()}"
        self._clock = clock
        self._fsync = bool(fsync)
        self._lock = threading.Lock()
        self._f = None
        # a reopened journal continues its lineage's sequence: the
        # crash-restart of a control node must not reset seq to 0 (a
        # reset would read as a gap — or worse, as silent overwrite)
        self._seq = 0
        for ev in replay_journal(path):
            if str(ev.get("node", "")) == self.node:
                self._seq = max(self._seq, int(ev.get("seq", 0)))
        #: observability of the journal itself
        self.events_written = 0
        self.append_errors = 0
        self._append_s: deque = deque(maxlen=2048)

    # -- ingestion -----------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> Optional[Dict[str, Any]]:
        """Append one event; returns the stamped event dict (None when
        the append failed — counted, logged once per failure)."""
        t0 = time.perf_counter()
        with self._lock:
            self._seq += 1
            ev: Dict[str, Any] = {"seq": self._seq, "kind": str(kind),
                                  "node": self.node,
                                  "wall_time": round(float(self._clock()),
                                                     6)}
            ev.update(fields)
            try:
                if self._f is None:
                    self._f = open(self.path, "a", encoding="utf-8")
                self._f.write(json.dumps(ev, default=str,
                                         separators=(",", ":")) + "\n")
                self._f.flush()
                if self._fsync:
                    os.fsync(self._f.fileno())
            except (OSError, ValueError):
                self.append_errors += 1
                log.exception("journal append failed (%s)", self.path)
                return None
            self.events_written += 1
            self._append_s.append(time.perf_counter() - t0)
            return ev

    # -- views ---------------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """Replay this journal's file (all writers, torn-tolerant),
        optionally filtered to one event kind."""
        with self._lock:
            if self._f is not None:
                self._f.flush()
        evs = replay_journal(self.path)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    def append_quantiles(self) -> Dict[str, float]:
        """p50/p99 of measured append cost in seconds — the bench
        ``fleet_obs`` row's journal-cost source."""
        with self._lock:
            vals = sorted(self._append_s)
        if not vals:
            return {"p50": 0.0, "p99": 0.0}
        return {"p50": vals[len(vals) // 2],
                "p99": vals[min(len(vals) - 1, int(0.99 * len(vals)))]}

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:  # pragma: no cover - teardown best-effort
                pass

    def __enter__(self) -> "EventJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
