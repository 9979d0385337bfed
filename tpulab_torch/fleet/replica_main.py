"""Replica server entrypoint — the process a real fleet is made of (the
port of ``tpulab/fleet/replica_main.py``).

``SubprocessReplicaProvider`` spawns this module (``python -m
tpulab_torch.fleet.replica_main``) once per replica: a paged
:class:`~tpulab_torch.engine.paged.ContinuousBatcher` behind the full gRPC
service, fixed-seed weights drawn on the serving device so every replica
in the fleet holds the same bits (the property resume-from-delivered
failover rides on), ``PORT <n>`` printed on stdout once the server is
bound, then a quiet main loop until a signal arrives.  Everything else
the process writes goes to stderr: nothing may fill the stdout pipe the
provider stops reading after the port line.

One difference from tpulab: tpulab's replica defaults to a CPU platform
and takes ``--native-platform``; this one serves on the CUDA card by
default and takes ``--device cpu``.  ``--n-kv-heads``, ``--ffn``,
``--untied``, ``--rope-theta``, ``--dtype``, ``--decode-block`` and
``--prefill-chunk`` describe a full-width model (Llama-3-8B: 32 layers,
d_model 4096, 32 / 8 heads, SwiGLU d_ff 14336, untied head, theta 5e5,
bf16).

Process lifecycle protocol (the k8s mapping, docs/SERVING.md "Running a
real fleet"):

- **SIGUSR1** = preStop drain: start ``InferenceManager.drain`` in the
  background — readiness flips false, ``StatusResponse.draining`` goes
  true, in-flight streams finish, nothing new is admitted.  The process
  does NOT exit; the provider polls Status until ``draining`` AND
  ``inflight_requests == 0`` AND ``queued_requests == 0``.
- **SIGTERM** = retire: a short best-effort drain, clean engine/server
  teardown, exit 0.  The provider escalates to SIGKILL after a grace
  window — a wedged teardown never blocks the fleet.
- **SIGKILL / crash** — the case the control plane exists for: clients
  fail over with resume-from-delivered, the supervisor respawns.

Chaos arms itself from the inherited ``TPULAB_CHAOS`` env at import
(tpulab_torch.chaos), so a parent can schedule a deterministic
mid-stream kill inside a real replica process (exit code 86).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

#: ``--dtype`` spellings -> torch dtype names
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpulab_torch.fleet.replica_main",
        description="one tpulab_torch fleet replica (module docstring)")
    ap.add_argument("--port", type=int, default=0,
                    help="gRPC port (0 = ephemeral; printed as 'PORT <n>')")
    ap.add_argument("--model-name", default="lm")
    ap.add_argument("--role", default="unified",
                    choices=("unified", "prefill", "decode"))
    ap.add_argument("--delay-ms", type=float, default=0.0,
                    help="pace token emission (tests hold streams in "
                         "flight across drains/kills deterministically)")
    ap.add_argument("--device", default="cuda",
                    help="serving device (default the CUDA card; the "
                         "tests pass 'cpu')")
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES),
                    help="weights and compute dtype")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=2)
    ap.add_argument("--n-kv-heads", type=int, default=None,
                    help="grouped-query KV heads (default n_heads)")
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--ffn", default="gelu", choices=("gelu", "swiglu"))
    ap.add_argument("--untied", action="store_true",
                    help="a separate lm_head instead of the tied "
                         "embedding")
    ap.add_argument("--rope-theta", type=float, default=None)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--decode-block", type=int, default=8,
                    help="fused-decode block ceiling")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens one prefill round carries per lane")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed — every fleet member must share it "
                         "(resume-from-delivered failover is bit-exact "
                         "only across identical weights)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--drain-timeout-s", type=float, default=120.0,
                    help="SIGUSR1 drain budget")
    ap.add_argument("--drain-settle-s", type=float, default=0.2,
                    help="readiness-flip settle window before the drain "
                         "may complete (k8s endpoint propagation)")
    ap.add_argument("--term-drain-s", type=float, default=2.0,
                    help="SIGTERM best-effort drain budget before exit")
    # evidence-on-exit: arm the per-replica Chrome trace / flight recorder
    # and autosave them — periodically AND on SIGUSR1 drain / SIGTERM
    # retire — so a retired (or killed) replica leaves artifacts behind.
    # Env fallbacks (TPULAB_TRACE_PATH / TPULAB_FLIGHT_PATH) let a
    # provider hand each spawn its own path without touching replica_args.
    ap.add_argument("--trace-path", default=None,
                    help="Chrome-trace dump path (env TPULAB_TRACE_PATH)")
    ap.add_argument("--flight-path", default=None,
                    help="flight-recorder JSONL dump path "
                         "(env TPULAB_FLIGHT_PATH)")
    ap.add_argument("--autosave-s", type=float, default=0.25,
                    help="evidence autosave period (SIGKILL leaves the "
                         "last periodic save; saves are atomic)")
    return ap


def _build_engine(args):
    import torch

    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import init_transformer_params

    device = resolve_device(args.device)
    dtype = getattr(torch, DTYPES[args.dtype])
    params = init_transformer_params(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, seed=args.seed,
        n_kv_heads=args.n_kv_heads, ffn=args.ffn,
        tie_embeddings=not args.untied, device=device, dtype=dtype)
    delay_s = args.delay_ms / 1e3

    class _Paced(ContinuousBatcher):
        """Token emission paced via the on_token hook (same shape as the
        fleet tests' in-process paced replicas)."""

        def submit(self, prompt, steps, on_token=None, **kw):
            if on_token is not None:
                inner = on_token

                def paced(*a, **k):
                    time.sleep(delay_s)
                    return inner(*a, **k)
                on_token = paced
            return super().submit(prompt, steps, on_token=on_token, **kw)

    cls = _Paced if delay_s > 0 else ContinuousBatcher
    return cls(params, n_heads=args.n_heads, n_layers=args.n_layers,
               n_kv_heads=args.n_kv_heads, rope_theta=args.rope_theta,
               lanes=args.lanes, max_len=args.max_len,
               page_size=args.page_size, decode_block=args.decode_block,
               prefill_chunk=args.prefill_chunk,
               prefix_cache=not args.no_prefix_cache,
               compute_dtype=dtype, device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trace_path = args.trace_path or os.environ.get("TPULAB_TRACE_PATH")
    flight_path = args.flight_path or os.environ.get("TPULAB_FLIGHT_PATH")
    # the port line goes to the real stdout; everything else (ours, torch's,
    # a kernel build's) to stderr, so the provider's pipe never fills
    port_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    import tpulab_torch

    trace_rec = flight_rec = None
    if trace_path:
        from tpulab_torch.utils.tracing import ChromeTraceRecorder
        trace_rec = ChromeTraceRecorder(
            process_name=f"replica:{args.model_name}")
    if flight_path:
        from tpulab_torch.obs import FlightRecorder
        flight_rec = FlightRecorder()

    def dump_evidence() -> None:
        """Best-effort artifact save (atomic tmp+rename on both paths —
        a save raced by SIGKILL leaves the previous complete file)."""
        try:
            if trace_rec is not None and len(trace_rec):
                trace_rec.save(trace_path)
        except Exception:  # noqa: BLE001 - evidence must not kill serving
            pass
        try:
            if flight_rec is not None and len(flight_rec):
                flight_rec.dump_jsonl(flight_path)
        except Exception:  # noqa: BLE001
            pass

    cb = _build_engine(args)
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device=cb.device)
    mgr.serve(port=args.port, generation_engines={args.model_name: cb},
              role=args.role, trace=trace_rec, flight=flight_rec)

    stop = threading.Event()
    draining = threading.Event()

    if trace_rec is not None or flight_rec is not None:
        # periodic autosave: a SIGKILLed replica still leaves its last
        # complete save behind
        def autosave() -> None:
            while not stop.wait(max(0.05, args.autosave_s)):
                dump_evidence()

        threading.Thread(target=autosave, name="replica-evidence",
                         daemon=True).start()

    def start_drain(*_sig) -> None:
        # preStop: idempotent, asynchronous — the signal handler must
        # return immediately; the provider watches Status for completion
        if draining.is_set():
            return
        draining.set()

        def run_drain() -> None:
            mgr.drain(timeout=args.drain_timeout_s,
                      settle_s=args.drain_settle_s)
            dump_evidence()  # drained = quiesced: a consistent capture

        threading.Thread(target=run_drain, name="replica-drain",
                         daemon=True).start()

    def request_stop(*_sig) -> None:
        stop.set()

    signal.signal(signal.SIGUSR1, start_drain)
    signal.signal(signal.SIGTERM, request_stop)
    signal.signal(signal.SIGINT, request_stop)

    port_out.write(f"PORT {mgr.server.bound_port}\n")
    port_out.flush()
    while not stop.wait(0.2):
        pass

    # retire: best-effort drain inside the provider's SIGTERM grace
    # window, then clean teardown — exit 0 is the supervisor's evidence
    # of a graceful retirement rather than a death
    try:
        mgr.drain(timeout=args.term_drain_s, settle_s=0.0)
    except Exception:  # noqa: BLE001 - teardown best-effort
        pass
    dump_evidence()  # evidence-on-exit: the artifacts outlive the process
    for closer in (mgr.shutdown, cb.shutdown):
        try:
            closer()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
