"""SubprocessReplicaProvider: the process-boundary replica lifecycle (the
port of ``tpulab/fleet/process.py``).

The :class:`~tpulab_torch.fleet.autoscaler.ReplicaProvider` that spawns REAL
replica server processes (``tpulab_torch.fleet.replica_main``) over loopback
gRPC — the smallest deployment that exercises every failure mode a
Kubernetes fleet has: a spawn is a Pod start, ``drain()`` is the preStop
hook, ``retire()`` is SIGTERM→grace→SIGKILL pod deletion, and a crash
is a crash (docs/SERVING.md "Running a real fleet").

Lifecycle contracts:

- **spawn** runs under the ``fleet.spawn`` chaos trip with bounded
  retry-with-backoff (:func:`~tpulab_torch.fleet.autoscaler.spawn_with_retry`)
  and gates readiness on the FIRST SUCCESSFUL Status RPC — a replica
  joins the ring only once it provably serves, never on "the process
  started" (the gap where k8s readiness probes live).
- **drain** sends SIGUSR1 (the replica starts
  ``InferenceManager.drain`` in-process) and polls Status until
  ``draining`` AND ``inflight_requests == 0`` AND
  ``queued_requests == 0`` — drain completion is judged from the
  OBSERVABLE wire state, not trusted process internals.  ``timeout_s``
  is a hard cap (provider conformance contract).
- **retire** = SIGTERM → ``term_grace_s`` wait → SIGKILL, then reap.
  Exit codes are retained (``exit_code``) so the supervisor can tell a
  graceful 0 from a chaos kill (``chaos.KILL_EXIT_CODE``).
"""

from __future__ import annotations

import logging
import os
import select
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from tpulab_torch.fleet.autoscaler import ReplicaProvider, spawn_with_retry

log = logging.getLogger("tpulab_torch.fleet")

__all__ = ["SubprocessReplicaProvider"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _Replica:
    """One spawned process + its cached Status client."""

    __slots__ = ("proc", "client", "address")

    def __init__(self, proc, client, address: str):
        self.proc, self.client, self.address = proc, client, address


class SubprocessReplicaProvider(ReplicaProvider):
    """Module docstring.  ``replica_args`` go straight to
    ``replica_main`` (e.g. ``("--delay-ms", "30")``); ``env`` overlays
    the child environment for every spawn, ``spawn(extra_env=...)`` for
    one spawn (a test arming ``TPULAB_CHAOS`` inside one victim)."""

    def __init__(self, model: str = "lm",
                 replica_args: tuple = (),
                 ready_timeout_s: float = 180.0,
                 term_grace_s: float = 5.0,
                 env: Optional[Dict[str, str]] = None,
                 python: Optional[str] = None):
        self._model = model
        self._replica_args = tuple(replica_args)
        self._ready_timeout_s = float(ready_timeout_s)
        self._term_grace_s = float(term_grace_s)
        self._env = dict(env or {})
        self._python = python or sys.executable
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self._exit_codes: Dict[str, Optional[int]] = {}

    # -- spawn ---------------------------------------------------------------
    def spawn(self, extra_env: Optional[Dict[str, str]] = None) -> str:
        return spawn_with_retry(lambda: self._spawn_once(extra_env),
                                backoff_s=0.25)

    def _spawn_once(self, extra_env: Optional[Dict[str, str]]) -> str:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH")) if p)
        env.update(self._env)
        env.update(extra_env or {})
        cmd = [self._python, "-m", "tpulab_torch.fleet.replica_main",
               "--port", "0", "--model-name", self._model,
               *self._replica_args]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                env=env)
        deadline = time.monotonic() + self._ready_timeout_s
        try:
            port = self._read_port(proc, deadline)
            addr = f"127.0.0.1:{port}"
            client = self._gate_ready(proc, addr, deadline)
        except Exception:
            self._reap(proc)
            raise
        with self._lock:
            self._replicas[addr] = _Replica(proc, client, addr)
        log.info("fleet spawn: replica %s up (pid %d)", addr, proc.pid)
        return addr

    @staticmethod
    def _read_port(proc, deadline: float) -> int:
        """Wait for the child's ``PORT <n>`` line (the only thing it
        prints on stdout) without ever blocking past the deadline."""
        buf = ""
        fd = proc.stdout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica exited rc={proc.returncode} before binding")
            r, _, _ = select.select([fd], [], [], 0.2)
            if not r:
                continue
            chunk = fd.readline()
            if not chunk:
                continue
            buf += chunk
            if chunk.startswith("PORT "):
                return int(chunk.split()[1])
        raise TimeoutError(f"replica never printed PORT (stdout={buf!r})")

    def _gate_ready(self, proc, addr: str, deadline: float):
        """Readiness gate: the first successful Status RPC admits the
        replica.  A bound-but-not-serving process never joins."""
        from tpulab_torch.rpc.infer_service import RemoteInferenceManager

        client = RemoteInferenceManager(addr)
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                client.close()
                raise RuntimeError(
                    f"replica {addr} exited rc={proc.returncode} "
                    "before first Status")
            try:
                client.server_status(timeout=2.0)
                return client
            except Exception:
                time.sleep(0.1)
        client.close()
        raise TimeoutError(f"replica {addr} never answered Status")

    # -- drain / retire ------------------------------------------------------
    def drain(self, address: str, timeout_s: float = 30.0) -> bool:
        with self._lock:
            rep = self._replicas.get(address)
        if rep is None:
            return True  # unknown = already gone
        if rep.proc.poll() is not None:
            return True  # dead = nothing left in flight
        os.kill(rep.proc.pid, signal.SIGUSR1)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if rep.proc.poll() is not None:
                return True
            try:
                resp = rep.client.server_status(
                    timeout=max(0.1, min(2.0,
                                         deadline - time.monotonic())))
            except Exception:
                time.sleep(0.05)
                continue
            if (resp.draining and resp.inflight_requests == 0
                    and resp.queued_requests == 0):
                return True
            time.sleep(0.05)
        return False

    def retire(self, address: str) -> None:
        with self._lock:
            rep = self._replicas.pop(address, None)
        if rep is None:
            return
        proc = rep.proc
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=self._term_grace_s)
            except subprocess.TimeoutExpired:
                log.warning("replica %s ignored SIGTERM for %.1fs; "
                            "escalating to SIGKILL", address,
                            self._term_grace_s)
                proc.kill()
                proc.wait()
        self._reap_streams(proc)
        with self._lock:
            self._exit_codes[address] = proc.returncode
        try:
            rep.client.close()
        except Exception:  # pragma: no cover - teardown best-effort
            pass
        log.info("fleet retire: replica %s exited rc=%s", address,
                 proc.returncode)

    # -- liveness evidence (FleetSupervisor) ---------------------------------
    def is_alive(self, address: str) -> Optional[bool]:
        with self._lock:
            rep = self._replicas.get(address)
        if rep is None:
            return None  # not ours — no process to observe
        return rep.proc.poll() is None

    def exit_code(self, address: str) -> Optional[int]:
        """Exit code of a dead/retired replica (None while alive or for
        strangers) — how the supervisor distinguishes a graceful 0 from
        a crash/chaos kill."""
        with self._lock:
            rep = self._replicas.get(address)
            if rep is not None:
                return rep.proc.poll()
            return self._exit_codes.get(address)

    def pid_of(self, address: str) -> Optional[int]:
        with self._lock:
            rep = self._replicas.get(address)
        return None if rep is None else rep.proc.pid

    def addresses(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def close(self) -> None:
        for a in self.addresses():
            self.retire(a)

    @staticmethod
    def _reap_streams(proc) -> None:
        try:
            if proc.stdout is not None:
                proc.stdout.close()
        except Exception:
            pass

    def _reap(self, proc) -> None:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        self._reap_streams(proc)
