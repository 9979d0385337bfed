"""End-to-end LLM serving: the full paged stack behind one gRPC endpoint
(the port of tpulab's ``examples/07_llm_server.py``).

Brings together every serving feature on a Llama-class model (random init,
or a HF ``LlamaForCausalLM`` state_dict via --checkpoint): continuous
batching over a paged KV pool, prefix caching, chunked prefill, priority
scheduling + preemption, sampling, stop tokens, optional weight-only INT8
and fp8 KV pages — served through the token-streaming Generate RPC.

Server (on the CUDA card; ``--device cpu`` serves from the host):
    python -m tpulab_torch.examples.ex07_llm_server --port 50055
Client (separate shell):
    python -m tpulab_torch.examples.ex07_llm_server \
        --connect localhost:50055 --prompt 1,2,3 --steps 16 \
        --temperature 0.8 --seed 7
Replicated client (comma-separated endpoints = least-loaded routing with
exactly-once crash failover via GenerationReplicaSet):
    python -m tpulab_torch.examples.ex07_llm_server \
        --connect localhost:50055,localhost:50056 --prompt 1,2,3
"""

import argparse
import sys

from tpulab_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--port", type=int, default=50055)
    ap.add_argument("--connect", default="",
                    help="client mode: host:port of a running server")
    ap.add_argument("--checkpoint", default="",
                    help="optional torch .pt/.pth LlamaForCausalLM state_dict")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="weight-only INT8 (W8A16)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="also serve greedy speculative decoding as model "
                         "'llm-spec' (K drafts/round; random-init demo "
                         "drafts with the target itself)")
    ap.add_argument("--kv-fp8", action="store_true",
                    help="fp8 e4m3 KV pages")
    ap.add_argument("--rope-theta", type=float, default=10000.0,
                    help="RoPE base (MUST match the checkpoint's config, "
                         "e.g. 500000 for Llama-3-class models)")
    # client-mode options
    ap.add_argument("--model", default="llm",
                    help="generation model name (llm | llm-spec)")
    ap.add_argument("--prompt", default="1,2,3,4")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass in (0, 1); takes effect "
                         "with --temperature > 0")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--stop-token", type=int, default=None)
    ap.add_argument("--device-sampling", action="store_true",
                    help="temperature sampling computed on the device")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="expose LLM serving metrics (tpulab_llm_*: "
                         "tokens/s, lanes, pages, prefix-cache, "
                         "preemptions) on this /metrics port")
    ap.add_argument("--max-inflight", type=int, default=0,
                    help="admission control: cap concurrently admitted "
                         "generations; overflow fast-fails with "
                         "RESOURCE_EXHAUSTED + retry_after_ms (0 = "
                         "admission off unless --tenant-rate is set)")
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="admission control: per-tenant request rate "
                         "limit in req/s (tenant = request tenant_id or "
                         "tpulab-tenant metadata; 0 = no rate limit)")
    ap.add_argument("--tenant", default="",
                    help="client mode: tenant identity to send "
                         "(admission-control fairness/rate bucket)")
    ap.add_argument("--role", default="unified",
                    choices=("unified", "prefill", "decode"),
                    help="disaggregated serving role: prefill replicas "
                         "export finished KV over the host tier's wire "
                         "form, decode replicas admit shipped KV with zero "
                         "prefill dispatches; implies kv_offload")
    ap.add_argument("--disaggregate", action="store_true",
                    help="client mode (multi-replica --connect): "
                         "role-aware prefill/decode routing")
    ap.add_argument("--oneshot", action="store_true",
                    help="server exits after first client disconnect (tests)")
    args = ap.parse_args(argv)

    import numpy as np

    if args.connect:
        prompt = np.asarray([int(t) for t in args.prompt.split(",")],
                            np.int32)
        stops = [args.stop_token] if args.stop_token is not None else ()
        kw = dict(temperature=args.temperature, top_p=args.top_p,
                  seed=args.seed, priority=args.priority, stop_tokens=stops,
                  device_sampling=args.device_sampling)
        if args.tenant:
            kw["tenant_id"] = args.tenant
        if "," in args.connect:
            # N replicas: least-loaded routing + exactly-once crash
            # failover (tpulab_torch.rpc.replica.GenerationReplicaSet)
            from tpulab_torch.rpc.replica import GenerationReplicaSet
            addrs = [a.strip() for a in args.connect.split(",") if a.strip()]
            grs = GenerationReplicaSet(addrs, args.model,
                                       disaggregate=args.disaggregate)
            try:
                for tok in grs.generate(prompt, args.steps, **kw):
                    print(tok, end=" ", flush=True)
                by = ", ".join(f"{a}={n}" for a, n in zip(addrs, grs.served))
                print(f"\ndone (requests per replica: {by})")
            finally:
                grs.close()
            return 0
        from tpulab_torch.rpc.infer_service import (GenerateStreamClient,
                                                    RemoteInferenceManager)
        remote = RemoteInferenceManager(args.connect)
        client = GenerateStreamClient(remote, args.model)
        for tok in client.generate(prompt, args.steps, **kw):
            print(tok, end=" ", flush=True)
        print("\ndone")
        remote.close()
        return 0

    import torch

    import tpulab_torch
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import init_transformer_params

    device = args.device
    rope_theta = args.rope_theta
    if args.checkpoint:
        from tpulab_torch.models.torch_import import llama_params_from_torch
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
        params = llama_params_from_torch(sd, device=device)
        # head geometry comes from the HF config — pass it on the CLI
        # (--heads/--kv-heads must match the checkpoint)
        layers = len([k for k in params if k.startswith("layer")])
        heads, kv_heads = args.heads, args.kv_heads
    else:
        params = init_transformer_params(
            vocab=args.vocab, d_model=args.d_model, n_heads=args.heads,
            n_layers=args.layers, d_ff=4 * args.d_model,
            n_kv_heads=args.kv_heads, tie_embeddings=False, device=device)
        heads, kv_heads, layers = args.heads, args.kv_heads, args.layers

    if args.int8:
        from tpulab_torch.models.quantization import \
            quantize_transformer_params
        params = quantize_transformer_params(params)

    cb = ContinuousBatcher(
        params, n_heads=heads, n_layers=layers, n_kv_heads=kv_heads,
        lanes=args.lanes, max_len=args.max_len, rope_theta=rope_theta,
        prefix_cache=True, prefill_chunk=256,
        kv_dtype=torch.float8_e4m3fn if args.kv_fp8 else None,
        # role'd replicas need the host tier: the KV handoff IS the
        # tiered-KV swap path in wire form (tpulab_torch.disagg)
        kv_offload=args.role != "unified" or None, device=device)

    engines = {"llm": cb}
    if args.speculative > 0:
        # target drafts for itself in this random-init demo (full
        # acceptance); with a real checkpoint pass a distilled draft to
        # SpeculativeGenerator instead
        from tpulab_torch.engine.speculative import (SpeculativeGenerator,
                                                     SpeculativeSessionEngine)
        spec = SpeculativeGenerator(
            params, params, n_heads=heads, n_layers=layers,
            n_kv_heads=kv_heads, k=args.speculative, max_len=args.max_len,
            compute_dtype=torch.float32, rope_theta=rope_theta,
            device=device)
        engines["llm-spec"] = SpeculativeSessionEngine(spec, max_sessions=2)

    import time

    gm = None
    if args.metrics_port:
        import threading

        from tpulab_torch.utils.metrics import (GenerationMetrics,
                                                start_metrics_server)
        gm = GenerationMetrics()
        start_metrics_server(gm, port=args.metrics_port)
        # latency distributions (TTFT/ITL/queue/e2e) are event-driven: the
        # batcher observes them per completed request at the source
        cb.metrics = gm

        def poll_loop():
            # gauges/counters still ride the cheap 2 s poll
            while True:
                try:
                    gm.poll(cb)
                except Exception:
                    return  # batcher gone: server is shutting down
                time.sleep(2.0)
        threading.Thread(target=poll_loop, daemon=True,
                         name="llm-metrics").start()

    admission = None
    if args.max_inflight or args.tenant_rate:
        # the QoS frontend gate: bounded inflight/queue, per-tenant fair
        # queuing, rate limits, overload fast-fail — sized to the batcher
        # so cost-aware admission sees real page pressure
        from tpulab_torch.serving import (AdmissionConfig,
                                          AdmissionController)
        max_inflight = args.max_inflight or 2 * args.lanes
        admission = AdmissionController(
            AdmissionConfig(max_inflight=max_inflight,
                            max_queue_depth=4 * max_inflight,
                            tenant_rate=args.tenant_rate),
            load=cb)

    # generation-only deployment: no dense models, just the Generate RPC
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device=device)
    mgr.serve(port=args.port, generation_engines=engines,
              admission=admission, role=args.role)
    print(f"LLM server on :{mgr.server.bound_port} "
          f"(lanes={args.lanes} max_len={args.max_len} "
          f"int8={args.int8} kv_fp8={args.kv_fp8} "
          f"kernel={cb.device.type == 'cuda'} "
          f"flash_prefill={cb.prefill_flash} "
          f"admission={'on' if admission else 'off'} role={args.role})",
          flush=True)
    try:
        if args.oneshot:
            # completed_requests is edge-proof (a fast generation can start
            # AND finish between active_lanes polls); either engine
            # finishing a request satisfies oneshot
            def _completed():
                return sum(getattr(e, "completed_requests", 0)
                           for e in engines.values())
            while _completed() == 0:
                time.sleep(0.1)
            time.sleep(2.0)  # let the final stream frames flush
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        mgr.shutdown()
        cb.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
