"""The port's inference service against tpulab's over the gRPC loopback,
in both directions (tpulab's ``RemoteInferenceManager`` against the
port's server, the port's against tpulab's), on one MNIST weight set
(``tree_from_numpy``) and one small paged transformer
(``params_from_numpy``), f32 on the CPU:

- Status: the model list, bucket ladder, IO specs and weight bytes, the
  role, ``free_kv_pages``, ``free_hbm_bytes`` under an ``HBMArbiter``,
  the drain and in-flight gauges;
- Infer (unary and batched) and StreamInfer outputs within
  1e-5 x max(1, max |y|), and every rejection's status code;
- admission rejection (``RESOURCE_EXHAUSTED`` + ``retry_after_ms``) on
  Infer and Generate, with nothing consumed;
- drain: readiness flips, an open Generate stream holds it;
- the same behaviors in process (``Server.invoke`` / ``invoke_stream``)
  answer with the bytes the loopback call answers with;
- the dense ``GenerationEngine`` against tpulab's, directly;
- the Fiber (event-loop) executor serving StreamInfer and Generate, a
  dead stream failing its pending futures, the Infer lifecycle spans;
- FetchKV's NOT_FOUND and UNKNOWN_MODEL answers both ways, and
  ``fleet=`` / ``kvfabric=`` on the service (the Debug ``fleet``
  section).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulab
import tpulab.rpc.infer_service as jsvc
import tpulab_torch
import tpulab_torch.rpc.infer_service as tsvc
from tpulab.engine.generation import GenerationEngine as JDense
from tpulab.engine.paged import ContinuousBatcher as JBatcher
from tpulab.hbm import HBMArbiter as JArb
from tpulab.models.mnist import make_mnist as jax_make_mnist
from tpulab.models.transformer import init_transformer_params
from tpulab.serving import AdmissionConfig as JAdmCfg
from tpulab.serving import AdmissionController as JAdm
from tpulab_torch.engine.generation import GenerationEngine as TDense
from tpulab_torch.engine.paged import ContinuousBatcher as TBatcher
from tpulab_torch.hbm import HBMArbiter as TArb
from tpulab_torch.models.convert import params_from_numpy, tree_from_numpy
from tpulab_torch.models.mnist import make_mnist
from tpulab_torch.rpc.server import LocalServicerContext
from tpulab_torch.serving import AdmissionConfig as TAdmCfg
from tpulab_torch.serving import AdmissionController as TAdm

torch.set_num_threads(2)

OUT = "Plus214_Output_0"
V, D, H, KV, L, F = 128, 64, 4, 2, 2, 128
ROPE = 10000.0
PAGED = dict(n_heads=H, n_layers=L, n_kv_heads=KV, rope_theta=ROPE,
             lanes=2, max_len=64, page_size=8, decode_block=4,
             prefill_chunk=16)
PROMPT = np.arange(3, 15, dtype=np.int32)
SVC = "/tpulab.inference.GRPCService"


def _close(got, want):
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 28, 28, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """tpulab's serving manager and the port's, each with MNIST and a
    paged batcher under an HBMArbiter."""
    p = init_transformer_params(V, D, H, L, F, seed=5, n_kv_heads=KV,
                                ffn="swiglu", tie_embeddings=False)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                           n_heads=H, n_kv_heads=KV, rope_theta=ROPE)
    jmnist = jax_make_mnist(max_batch_size=4, seed=3)
    tree = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jmnist.params),
                           "cpu")
    jarb, tarb = JArb(1 << 30, measure_scratch=False), TArb(
        1 << 30, measure_scratch=False)
    jcb = JBatcher(p, use_kernel=False, ragged=True, hbm=jarb,
                   compute_dtype=jnp.float32, **PAGED)
    tcb = TBatcher(tp, hbm=tarb, compute_dtype=torch.float32, device="cpu",
                   **PAGED)
    jm = tpulab.InferenceManager(max_exec_concurrency=2)
    jm.register_model("mnist", jmnist)
    jm.serve(port=0, generation_engines={"lm": jcb}, hbm=jarb,
             role="decode")
    tm = tpulab_torch.InferenceManager(max_exec_concurrency=2, device="cpu")
    tm.register_model("mnist", make_mnist(max_batch_size=4, params=tree))
    tm.serve(port=0, generation_engines={"lm": tcb}, hbm=tarb,
             role="decode")
    yield dict(jm=jm, tm=tm, jcb=jcb, tcb=tcb, jarb=jarb, tarb=tarb, p=p,
               tp=tp)
    for x in (jm, tm, jcb, tcb):
        x.shutdown()


def _remote(svc, mgr):
    return svc.RemoteInferenceManager(f"127.0.0.1:{mgr.server.bound_port}")


def _status_fields(resp):
    return dict(
        models=[(m.name, m.max_batch_size, list(m.batch_buckets),
                 m.weights_bytes,
                 [(s.name, s.dtype, list(s.dims)) for s in m.inputs],
                 [(s.name, s.dtype, list(s.dims)) for s in m.outputs])
                for m in resp.models],
        code=resp.status.code, server_version=resp.server_version,
        queued=resp.queued_requests, free_kv_pages=resp.free_kv_pages,
        role=resp.role, resident=list(resp.resident_models),
        host=list(resp.host_models), free_hbm=resp.free_hbm_bytes,
        prefix=(resp.prefix_hits, resp.prefix_lookups),
        draining=resp.draining, inflight=resp.inflight_requests)


def test_status_fields_match_both_ways(pair):
    got = {}
    for client in (jsvc, tsvc):
        for side in ("jm", "tm"):
            r = _remote(client, pair[side])
            try:
                got[(client.__name__, side)] = _status_fields(
                    r.server_status(timeout=30))
                unknown = r._status.call(client.pb.StatusRequest(
                    model_name="nope"), timeout=30)
                assert unknown.status.code == client.pb.UNKNOWN_MODEL
            finally:
                r.close()
    want = got[("tpulab.rpc.infer_service", "jm")]
    assert want["models"][0][:3] == ("mnist", 4, [1, 2, 4])
    assert want["free_kv_pages"] == pair["tcb"].pool.free_pages > 0
    assert want["free_hbm"] == pair["tarb"].free_hbm_bytes > 0
    assert want["role"] == "decode" and want["code"] == 1
    for k, v in got.items():
        assert v == want, k


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_infer_and_stream_infer_cross_wire(pair, batch):
    x = _images(batch, batch)
    want = pair["jm"].infer_runner("mnist").infer(Input3=x).result(60)[OUT]
    for client in (jsvc, tsvc):
        for side in ("jm", "tm"):
            r = _remote(client, pair[side])
            try:
                runner = r.infer_runner("mnist")
                assert runner.input_bindings()["Input3"] == (
                    (28, 28, 1), np.dtype(np.float32))
                _close(runner.infer(Input3=x).result(60)[OUT], want)
                stream = client.StreamInferClient(r, "mnist")
                futs = [stream.submit(Input3=x) for _ in range(4)]
                for f in futs:
                    _close(f.result(60)[OUT], want)
                stream.close()
            finally:
                r.close()


# (inputs, requested_outputs) -> the status code name tpulab answers
INFER_BAD = [
    (dict(Input3=np.zeros((1, 28, 28, 1), np.float64)), None,
     "INVALID_ARGUMENT"),
    (dict(Input3=np.zeros((1, 28, 28, 2), np.float32)), None,
     "INVALID_ARGUMENT"),
    (dict(Input3=np.zeros((5, 28, 28, 1), np.float32)), None,
     "INVALID_ARGUMENT"),
    (dict(Input3=np.zeros((0, 28, 28, 1), np.float32)), None,
     "INVALID_ARGUMENT"),
    (dict(Other=np.zeros((1, 28, 28, 1), np.float32)), None,
     "INVALID_ARGUMENT"),
    (dict(Input3=np.zeros((1, 28, 28, 1), np.float32)), ["typo"],
     "INVALID_ARGUMENT"),
]


def _infer_code(client, mgr, model, inputs, outputs):
    r = _remote(client, mgr)
    try:
        req = client.pb.InferRequest(model_name=model, batch_size=1)
        for k, v in inputs.items():
            req.inputs.append(client.tensor_to_proto(k, v))
        if outputs:
            req.requested_outputs.extend(outputs)
        resp = r._infer.call(req, timeout=60)
        return client.pb.StatusCode.Name(resp.status.code)
    finally:
        r.close()


@pytest.mark.parametrize("i", range(len(INFER_BAD) + 1))
def test_infer_rejection_codes_match(pair, i):
    if i == len(INFER_BAD):
        inputs, outputs, want, model = (dict(Input3=np.zeros(
            (1, 28, 28, 1), np.float32)), None, "UNKNOWN_MODEL", "nope")
    else:
        (inputs, outputs, want), model = INFER_BAD[i], "mnist"
    for client in (jsvc, tsvc):
        for side in ("jm", "tm"):
            assert _infer_code(client, pair[side], model, inputs,
                               outputs) == want
    mgr = pair["tm"]                           # nothing was consumed
    for pool in (mgr.buffers_pool, mgr.exec_tokens,
                 mgr.context_pool("mnist")):
        assert pool.available == pool.size


def test_admission_rejection_matches(pair):
    """A controller with no room rejects Infer and Generate with
    RESOURCE_EXHAUSTED and tpulab's ``retry_after_ms``; nothing is
    consumed, every lane and page stays home."""
    servers = []
    try:
        for mod, mgr_cls, adm, cfg, mnist, kw in (
                (jsvc, tpulab.InferenceManager, JAdm, JAdmCfg,
                 jax_make_mnist(max_batch_size=2), {}),
                (tsvc, tpulab_torch.InferenceManager, TAdm, TAdmCfg,
                 make_mnist(max_batch_size=2, device="cpu"),
                 dict(device="cpu"))):
            m = mgr_cls(**kw)
            m.register_model("mnist", mnist)
            eng = pair["jcb"] if mod is jsvc else pair["tcb"]
            m.serve(port=0, generation_engines={"lm": eng},
                    admission=adm(cfg(max_inflight=0, max_queue_depth=0,
                                      min_retry_after_ms=70)))
            servers.append((mod, m))
        outs = []
        for client in (jsvc, tsvc):
            for mod, m in servers:
                r = _remote(client, m)
                try:
                    with pytest.raises(client.ResourceExhausted) as e:
                        r.infer_runner("mnist").infer(Input3=np.zeros(
                            (1, 28, 28, 1), np.float32)).result(60)
                    with pytest.raises(client.ResourceExhausted) as g:
                        list(client.GenerateStreamClient(r, "lm").generate(
                            PROMPT, 4, tenant_id="t1"))
                    outs.append((e.value.retry_after_ms,
                                 g.value.retry_after_ms, g.value.code))
                finally:
                    r.close()
        assert set(outs) == {(70, 70, tsvc.pb.RESOURCE_EXHAUSTED)}
        assert pair["tcb"].active_lanes == 0
        assert pair["tcb"].pool.free_pages == pair["tcb"].pool.n_pages - 1
    finally:
        for _, m in servers:
            m.shutdown()


def test_in_process_calls_equal_loopback(pair):
    """The server's own behaviors, called in process with serialized
    bytes (how the card's machine, without grpc, drives the service),
    answer with the bytes the loopback answers with."""
    from tpulab_torch.rpc.protos import inference_pb2 as pb
    server = pair["tm"].server
    x = _images(2, 11)
    infer = pb.InferRequest(model_name="mnist", batch_size=2,
                            inputs=[tsvc.tensor_to_proto("Input3", x)])
    gen = pb.GenerateRequest(model_name="lm", prompt=PROMPT, steps=6,
                             temperature=0.7, seed=4, device_sampling=True,
                             return_logprobs=True)
    r = _remote(tsvc, pair["tm"])
    try:
        for method, req, stub in (("Health", pb.HealthRequest(), r._health),
                                  ("Infer", infer, r._infer)):
            wire = stub.call(req, timeout=60).SerializeToString()
            local = server.invoke(f"{SVC}/{method}",
                                  req.SerializeToString())
            assert local == wire
        wire = []
        list(tsvc.GenerateStreamClient(r, "lm").generate(
            PROMPT, 6, temperature=0.7, seed=4, device_sampling=True,
            return_logprobs=True, _final=wire))
        local = [pb.GenerateResponse.FromString(b) for b in
                 server.invoke_stream(f"{SVC}/Generate",
                                      [gen.SerializeToString()])]
        assert len(local) == 7 and local[-1] == wire[-1]
        toks = [(m.token, m.index, m.logprob) for m in local[:-1]]
        streamed = list(tsvc.GenerateStreamClient(r, "lm").generate(
            PROMPT, 6, temperature=0.7, seed=4, device_sampling=True,
            return_logprobs=True))
        assert [(t, lp) for t, _, lp in toks] == streamed
        assert [i for _, i, _ in toks] == list(range(6))
        # metadata rides the local context as it rides grpc's
        meta = LocalServicerContext([("tpulab-tenant", "acme")])
        assert server.invoke(f"{SVC}/Status", b"", meta)
    finally:
        r.close()


def test_client_drop_in_process_frees_the_lane(pair):
    """A consumer that cancels mid-decode (the local context going
    inactive) ends the stream without a final and frees the lane."""
    from tpulab_torch.rpc.protos import inference_pb2 as pb
    cb, server = pair["tcb"], pair["tm"].server
    ctx = LocalServicerContext()
    req = pb.GenerateRequest(model_name="lm", prompt=PROMPT, steps=40)
    got = []
    for b in server.invoke_stream(f"{SVC}/Generate",
                                  [req.SerializeToString()], ctx):
        got.append(pb.GenerateResponse.FromString(b))
        if len(got) == 2:
            ctx.cancel()
    assert len(got) < 40 and not any(m.final for m in got)
    end = time.monotonic() + 30
    while cb.active_lanes and time.monotonic() < end:
        time.sleep(0.01)
    assert cb.active_lanes == 0
    assert cb.pool.free_pages == cb.pool.n_pages - 1


def test_drain_flips_readiness_and_waits_for_a_stream():
    """``drain`` turns readiness off at once and returns only after an
    open Generate stream has finished; Health and Status report it."""
    params = init_transformer_params(V, D, H, L, F, seed=1, n_kv_heads=KV)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           "cpu", n_heads=H, n_kv_heads=KV)
    eng = TDense(tp, n_heads=H, n_layers=L, n_kv_heads=KV, max_len=64,
                 max_sessions=1, compute_dtype=torch.float32, device="cpu")

    class Paced:
        vocab = eng.vocab

        def start_session(self, timeout=None):
            import contextlib

            @contextlib.contextmanager
            def wrap():
                with eng.start_session(timeout=timeout) as sess:
                    class S:
                        prefill = staticmethod(sess.prefill)

                        @staticmethod
                        def stream(steps):
                            for tok in sess.stream(steps):
                                time.sleep(0.03)
                                yield tok
                    yield S()
            return wrap()

    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=1, device="cpu"))
    mgr.serve(port=0, generation_engines={"lm": Paced()})
    jr = _remote(jsvc, mgr)
    try:
        toks, t_done = [], [None]

        def consume():
            toks.extend(jsvc.GenerateStreamClient(jr, "lm").generate(
                np.arange(4, dtype=np.int32), 20))
            t_done[0] = time.monotonic()

        assert jr.health().ready
        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.2)
        assert jr.server_status().inflight_requests == 1
        drained = mgr.drain(timeout=60.0, settle_s=0.1)
        t_drained = time.monotonic()
        h = jr.health()
        t.join(timeout=60)
        assert drained and len(toks) == 20
        assert h.live and not h.ready
        assert jr.server_status().draining
        assert t_drained >= t_done[0] - 0.1
    finally:
        jr.close()
        mgr.shutdown()


def test_dense_generation_engine_matches_tpulab():
    params = init_transformer_params(V, D, H, L, F, seed=7, n_kv_heads=KV,
                                     ffn="swiglu", tie_embeddings=False)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           "cpu", n_heads=H, n_kv_heads=KV, rope_theta=ROPE)
    kw = dict(n_heads=H, n_layers=L, n_kv_heads=KV, rope_theta=ROPE,
              max_len=48, max_sessions=1)
    j = JDense(params, compute_dtype=jnp.float32, **kw)
    t = TDense(tp, compute_dtype=torch.float32, device="cpu", **kw)
    assert t.vocab == j.vocab == V
    prompt = np.random.default_rng(2).integers(0, V, (2, 9)).astype(np.int32)
    np.testing.assert_array_equal(t.generate(prompt, 8),
                                  j.generate(prompt, 8))
    for eng in (j, t):
        with eng.start_session() as s:
            s.prefill(prompt[0])
            first = s.step()
            rest = list(s.stream(6))
            eng.streams = [first] + rest
        assert eng.available_sessions == 1
    assert t.streams == j.streams
    for eng in (j, t):
        with pytest.raises(ValueError, match="outside"):
            eng.generate(np.array([[V]], np.int32), 2)
        with eng.start_session() as s:
            with pytest.raises(ValueError, match="max_len"):
                s.prefill(np.zeros(49, np.int32))
            with pytest.raises(RuntimeError, match="prefill"):
                s.step()


def test_not_ported_parts_name_their_item(pair):
    """The parts that were once stubs answer as tpulab's: FetchKV on an
    engine without ``kv_publish`` is an honest NOT_FOUND (None) and an
    unknown model raises naming UNKNOWN_MODEL, from either server to
    either client; the service takes ``fleet=`` and ``kvfabric=``, and
    the Debug snapshot carries the fleet handle's document."""
    import json
    from types import SimpleNamespace

    for client in (jsvc, tsvc):
        for side in ("jm", "tm"):
            r = _remote(client, pair[side])
            try:
                assert r.fetch_kv("lm", b"\0" * 16) is None
                with pytest.raises(RuntimeError, match="UNKNOWN_MODEL"):
                    r.fetch_kv("nope", b"\0" * 16)
            finally:
                r.close()
    fleet = SimpleNamespace(snapshot=lambda: {"leader_ticks": 3})
    server = tsvc.build_infer_service(
        pair["tm"], generation_engines={"lm": pair["tcb"]}, fleet=fleet,
        kvfabric=SimpleNamespace())
    resp = tsvc.pb.DebugResponse.FromString(server.invoke(
        f"/{tsvc.SERVICE_NAME}/Debug",
        tsvc.pb.DebugRequest().SerializeToString()))
    assert json.loads(resp.snapshot_json)["fleet"] == {"leader_ticks": 3}


def test_fiber_executor_serves_stream_infer_and_generate(pair):
    """On the event-loop (Fiber) executor StreamInfer drains without
    stalling the loop (a Status call interleaves with the open stream)
    and Generate runs on the generate workers, with the thread
    executor's tokens."""
    from tpulab_torch.rpc.executor import FiberExecutor
    base = _remote(tsvc, pair["tm"])
    try:
        want = _stream_tokens(base)
    finally:
        base.close()
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=2, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=2, device="cpu"))
    mgr.serve(port=0, executor=FiberExecutor(),
              generation_engines={"lm": pair["tcb"]})
    r = _remote(tsvc, mgr)
    try:
        client = tsvc.StreamInferClient(r, "mnist")
        x = _images(1, 4)
        futs = [client.submit(Input3=x) for _ in range(6)]
        assert "mnist" in r.get_models(timeout=30)
        want_y = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        for f in futs:
            _close(f.result(60)[OUT], want_y)
        client.close()
        assert _stream_tokens(r) == want
    finally:
        r.close()
        mgr.shutdown()


def _stream_tokens(remote):
    return list(tsvc.GenerateStreamClient(remote, "lm").generate(
        PROMPT, 8, temperature=0.7, seed=2, device_sampling=True))


def test_dead_stream_fails_pending_and_trace_spans(pair):
    """Killing the server fails a StreamInfer client's outstanding
    futures promptly; a traced service records tpulab's Infer lifecycle
    spans tagged with the trace id that rode the metadata."""
    from tpulab_torch.utils.tracing import TRACE_METADATA_KEY, \
        ChromeTraceRecorder
    rec = ChromeTraceRecorder()
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=1, device="cpu"))
    mgr.serve(port=0, trace=rec)
    r = _remote(tsvc, mgr)
    try:
        x = np.zeros((1, 28, 28, 1), np.float32)
        r.infer_runner("mnist").infer(Input3=x, trace_id="abc123").result(60)
        names = {e["name"]: e for e in rec._events}
        assert {"batch_wait", "pipeline", "respond"} <= set(names)
        assert names["pipeline"]["args"]["trace_id"] == "abc123"
        local = mgr.server.invoke(
            f"{SVC}/Infer", tsvc.pb.InferRequest(
                model_name="mnist", batch_size=1,
                inputs=[tsvc.tensor_to_proto("Input3", x)]
            ).SerializeToString(),
            LocalServicerContext([(TRACE_METADATA_KEY, "meta7")]))
        assert tsvc.pb.InferResponse.FromString(local).status.code == 1
        assert [e for e in rec._events if e.get("args", {}).get(
            "trace_id") == "meta7"]
        client = tsvc.StreamInferClient(r, "mnist")
        client.submit(Input3=x).result(timeout=60)
        mgr.server.shutdown(grace_s=0.1)
        with pytest.raises(Exception):
            client.submit(Input3=x).result(timeout=30)
    finally:
        r.close()
        mgr.shutdown()
