"""The Generate RPC across the wire, both directions: tpulab's client
against the port's server and the port's client against tpulab's server,
each held against tpulab's client and server on the same weights (bridged
with ``params_from_numpy``), f32, over the gRPC loopback.

- token streams, greedy and device-sampled (threefry is bit-exact), with
  logprobs within 1e-5, from the paged batcher under both dispatch plans
  (tpulab's ``use_kernel=False`` ragged and split plans: the port's
  ``device="cpu"`` batchers run the kernels' plain versions), from the
  dense ``GenerationEngine`` and from the speculative session engine
  (the target as its own draft);
- ``resume_length`` resumes equal the tail of the full stream;
- every validation failure's status code equals tpulab's;
- the ``prefill_only`` -> ``kv_shipment`` hop between two port servers
  decodes the unified stream with zero prompt fills on the decode side,
  and a corrupt shipment degrades to a local prefill;
- the service's chaos sites (``rpc.stream``,
  ``rpc.server.generate_token``, ``rpc.client.unary``,
  ``rpc.client.stream_recv``, ``serving.admission``, ``engine.step``),
  each with ``error`` and ``drop``: the outcome (status code, stream end,
  tokens delivered) equals tpulab's, and every lane and page is home.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulab
import tpulab.chaos as jchaos
import tpulab.rpc.infer_service as jsvc
import tpulab_torch
import tpulab_torch.chaos as tchaos
import tpulab_torch.rpc.infer_service as tsvc
from tpulab.engine.generation import GenerationEngine as JDense
from tpulab.engine.paged import ContinuousBatcher as JBatcher
from tpulab.engine.speculative import SpeculativeGenerator as JSpecGen
from tpulab.engine.speculative import SpeculativeSessionEngine as JSpecEng
from tpulab.models.mnist import make_mnist as jax_make_mnist
from tpulab.models.transformer import init_transformer_params
from tpulab.serving import AdmissionConfig as JAdmCfg
from tpulab.serving import AdmissionController as JAdm
from tpulab_torch.engine.generation import GenerationEngine as TDense
from tpulab_torch.engine.paged import ContinuousBatcher as TBatcher
from tpulab_torch.engine.speculative import SpeculativeGenerator as TSpecGen
from tpulab_torch.engine.speculative import \
    SpeculativeSessionEngine as TSpecEng
from tpulab_torch.models.convert import params_from_numpy, tree_from_numpy
from tpulab_torch.models.mnist import make_mnist
from tpulab_torch.serving import AdmissionConfig as TAdmCfg
from tpulab_torch.serving import AdmissionController as TAdm

torch.set_num_threads(2)

V, D, H, KV, L, F = 128, 64, 4, 2, 2, 128
ROPE = 10000.0
MAX_LEN = 96
PAGED = dict(n_heads=H, n_layers=L, n_kv_heads=KV, rope_theta=ROPE,
             lanes=2, max_len=MAX_LEN, page_size=8, decode_block=4,
             prefill_chunk=16)
DENSE = dict(n_heads=H, n_layers=L, n_kv_heads=KV, rope_theta=ROPE,
             max_len=MAX_LEN, max_sessions=1)
SPEC = dict(n_heads=H, n_layers=L, n_kv_heads=KV, rope_theta=ROPE,
            max_len=MAX_LEN, k=3)
LOGPROB_TOL = 1e-5
PROMPT = np.random.default_rng(0).integers(0, V, (20,)).astype(np.int32)


def _jax_params():
    return init_transformer_params(V, D, H, L, F, seed=11, n_kv_heads=KV,
                                   ffn="swiglu", tie_embeddings=False)


def _port_params(p):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                             n_heads=H, n_kv_heads=KV, rope_theta=ROPE)


class _Side:
    """One package's server (MNIST + three generation engines) and its
    client module."""

    def __init__(self, name, mgr, engines, svc, chaos):
        self.name, self.mgr, self.engines = name, mgr, engines
        self.svc, self.chaos = svc, chaos
        self.target = f"127.0.0.1:{mgr.server.bound_port}"

    def remote(self, svc=None):
        return (svc or self.svc).RemoteInferenceManager(self.target)


@pytest.fixture(scope="module")
def sides():
    p = _jax_params()
    tp = _port_params(p)
    jmnist = jax_make_mnist(max_batch_size=2, seed=3)
    jeng = {
        "lm": JBatcher(p, use_kernel=False, ragged=True,
                       compute_dtype=jnp.float32, **PAGED),
        "split": JBatcher(p, use_kernel=False, ragged=False,
                          prefill_flash=False, compute_dtype=jnp.float32,
                          **PAGED),
        "dense": JDense(p, compute_dtype=jnp.float32, **DENSE),
        "spec": JSpecEng(JSpecGen(p, p, compute_dtype=jnp.float32, **SPEC),
                         max_sessions=1)}
    teng = {
        "lm": TBatcher(tp, compute_dtype=torch.float32, device="cpu",
                       **PAGED),
        "split": TBatcher(tp, ragged=False, prefill_flash=False,
                          compute_dtype=torch.float32, device="cpu",
                          **PAGED),
        "dense": TDense(tp, compute_dtype=torch.float32, device="cpu",
                        **DENSE),
        "spec": TSpecEng(TSpecGen(tp, tp, compute_dtype=torch.float32,
                                  device="cpu", **SPEC), max_sessions=1)}
    jm = tpulab.InferenceManager(max_exec_concurrency=1)
    jm.register_model("mnist", jmnist)
    jm.serve(port=0, generation_engines=jeng, admission=JAdm(JAdmCfg(
        max_inflight=16, max_queue_depth=16)))
    tm = tpulab_torch.InferenceManager(max_exec_concurrency=1, device="cpu")
    tm.register_model("mnist", make_mnist(max_batch_size=2, params=tree_from_numpy(
        jax.tree_util.tree_map(np.asarray, jmnist.params), "cpu")))
    tm.serve(port=0, generation_engines=teng, admission=TAdm(TAdmCfg(
        max_inflight=16, max_queue_depth=16)))
    out = (_Side("tpulab", jm, jeng, jsvc, jchaos),
           _Side("port", tm, teng, tsvc, tchaos))
    yield out
    for side in out:
        side.mgr.shutdown()
        for e in side.engines.values():
            if hasattr(e, "shutdown"):
                e.shutdown()


def _stream(client_svc, side, engine, prompt=PROMPT, steps=10, **kw):
    remote = side.remote(client_svc)
    try:
        return list(client_svc.GenerateStreamClient(remote, engine).generate(
            prompt, steps, timeout=120, **kw))
    finally:
        remote.close()


def _lanes_home(engine, timeout=30.0):
    pool = getattr(engine, "pool", None)
    if pool is None:
        if not hasattr(engine, "available_sessions"):   # speculative
            return engine._sem.acquire(timeout=timeout) and (
                engine._sem.release() or True)
        return engine.available_sessions == 1
    want = pool.n_pages - 1              # page 0 is the scratch page
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if (engine.active_lanes == 0 and engine.queued_requests == 0
                and pool.free_pages == want):
            return True
        time.sleep(0.02)
    return False


MODES = {
    "greedy": dict(),
    "device": dict(temperature=0.8, seed=5, device_sampling=True),
    "logprobs": dict(return_logprobs=True),
    "device_logprobs": dict(temperature=0.9, seed=9, device_sampling=True,
                            return_logprobs=True, stop_tokens=[3]),
}


@pytest.mark.parametrize("engine,mode", [
    ("lm", m) for m in MODES] + [("split", m) for m in MODES]
    + [("dense", "greedy"), ("spec", "greedy")])
def test_generate_streams_cross_wire(sides, engine, mode):
    jside, tside = sides
    kw = MODES[mode]
    want = _stream(jsvc, jside, engine, **kw)        # tpulab -> tpulab
    runs = {"tpulab client -> port server": _stream(jsvc, tside, engine,
                                                    **kw),
            "port client -> tpulab server": _stream(tsvc, jside, engine,
                                                    **kw),
            "port client -> port server": _stream(tsvc, tside, engine,
                                                  **kw)}
    assert len(want) >= 1
    for label, got in runs.items():
        if kw.get("return_logprobs"):
            assert [t for t, _ in got] == [t for t, _ in want], label
            err = max(abs(a - b) for (_, a), (_, b) in zip(got, want))
            assert err <= LOGPROB_TOL, (label, err)
        else:
            assert got == want, label
    for side in sides:
        assert _lanes_home(side.engines[engine])


@pytest.mark.parametrize("engine", ["lm", "dense"])
def test_resume_length_continues_the_stream(sides, engine):
    """A resume (prompt + 5 delivered tokens, ``resume_length=5``) streams
    what tpulab's server streams for it; on the paged batcher that is the
    full stream's tail.  (tpulab's dense session stream starts at its
    second greedy pick, so a dense resume is not the full stream's tail
    there either; the port keeps tpulab's behavior.)"""
    jside, tside = sides
    full = _stream(jsvc, jside, engine, steps=12)
    delivered = 5
    resumed_prompt = np.concatenate([PROMPT, np.asarray(full[:delivered],
                                                        np.int32)])
    want = _stream(jsvc, jside, engine, prompt=resumed_prompt, steps=12,
                   resume_length=delivered)
    assert len(want) == 12 - delivered
    if engine == "lm":
        assert want == full[delivered:]
    for client, side in ((jsvc, tside), (tsvc, jside), (tsvc, tside)):
        got = _stream(client, side, engine, prompt=resumed_prompt, steps=12,
                      resume_length=delivered)
        assert got == want, (client.__name__, side.name)


# every validation failure: (engine, generate kwargs); the codes must
# match tpulab's (and are listed for the reader)
BAD = [
    ("nope", dict(), "UNKNOWN_MODEL"),
    ("lm", dict(device_sampling=True, temperature=0.5, top_k=3),
     "INVALID_ARGUMENT"),
    ("lm", dict(top_p=1.5), "INVALID_ARGUMENT"),
    ("lm", dict(temperature=-0.5), "INVALID_ARGUMENT"),
    ("lm", dict(temperature=float("nan")), "INVALID_ARGUMENT"),
    ("lm", dict(prompt=np.array([1, V], np.int32)), "INVALID_ARGUMENT"),
    ("lm", dict(prompt=np.array([-1, 2], np.int32)), "INVALID_ARGUMENT"),
    ("lm", dict(request_class="bulk"), "INVALID_ARGUMENT"),
    ("lm", dict(request_class="batch", prefill_only=True),
     "INVALID_ARGUMENT"),
    ("lm", dict(resume_length=10), "INVALID_ARGUMENT"),
    ("lm", dict(resume_length=-1), "INVALID_ARGUMENT"),
    ("lm", dict(resume_length=2, temperature=0.7), "INVALID_ARGUMENT"),
    ("lm", dict(prompt=np.array([1, 2], np.int32), resume_length=3,
                steps=6), "INVALID_ARGUMENT"),
    ("lm", dict(prompt=np.zeros(0, np.int32)), "INVALID_ARGUMENT"),
    ("lm", dict(steps=MAX_LEN), "INVALID_ARGUMENT"),
    ("lm", dict(prefill_only=True), "INVALID_ARGUMENT"),   # no kv_offload
    ("dense", dict(temperature=0.5), "INVALID_ARGUMENT"),
    ("dense", dict(priority=2), "INVALID_ARGUMENT"),
    ("dense", dict(return_logprobs=True), "INVALID_ARGUMENT"),
    ("dense", dict(prefill_only=True), "INVALID_ARGUMENT"),
    ("dense", dict(prompt=np.array([V + 3], np.int32)), "INVALID_ARGUMENT"),
    ("dense", dict(prompt=np.arange(100, dtype=np.int32) % V),
     "INVALID_ARGUMENT"),
    # past max_len mid-stream: an internal fault, not a request error
    ("dense", dict(prompt=np.arange(90, dtype=np.int32) % V), "INTERNAL"),
]


def _code(client, side, engine, kw):
    kw = dict(kw)
    prompt = kw.pop("prompt", PROMPT)
    steps = kw.pop("steps", 10)
    try:
        _stream(client, side, engine, prompt=prompt, steps=steps, **kw)
    except client.GenerationRejected as e:
        return client.pb.StatusCode.Name(e.code)
    return "SUCCESS"


@pytest.mark.parametrize("i", range(len(BAD)))
def test_rejection_codes_match_tpulab(sides, i):
    engine, kw, want = BAD[i]
    jside, tside = sides
    assert _code(jsvc, jside, engine, kw) == want
    assert _code(jsvc, tside, engine, kw) == want
    assert _code(tsvc, tside, engine, kw) == want
    if engine != "nope":
        assert _lanes_home(tside.engines[engine])


def test_batch_class_is_refused_until_the_batch_lane_is_ported(sides):
    """The batch lane is ported: a ``request_class='batch'`` stream rides
    the paged batcher's offline lane and streams what tpulab's server
    streams, greedy and device-sampled, in every client/server pairing;
    the lane is tagged batch in the engine's flight summary and every
    lane and page is home after."""
    jside, tside = sides
    for kw in (dict(), MODES["device"]):
        want = _stream(jsvc, jside, "lm", request_class="batch", **kw)
        assert want == _stream(jsvc, jside, "lm", **kw)
        for client, side in ((jsvc, tside), (tsvc, jside), (tsvc, tside)):
            got = _stream(client, side, "lm", request_class="batch", **kw)
            assert got == want, (client.__name__, side.name)
    for side in sides:
        assert _lanes_home(side.engines["lm"])


def test_prefill_export_then_shipped_decode_between_port_servers(sides):
    """A prefill-role port server exports the prompt's KV; a decode-role
    port server admits the shipment with zero prompt fills and streams
    the unified server's tokens; a corrupt shipment degrades to a local
    prefill with the same tokens."""
    _, tside = sides
    tp = _port_params(_jax_params())
    servers, engines = [], []
    try:
        for role in ("prefill", "decode"):
            cb = TBatcher(tp, compute_dtype=torch.float32, device="cpu",
                          kv_offload=True, **PAGED)
            mgr = tpulab_torch.InferenceManager(device="cpu")
            mgr.serve(port=0, generation_engines={"lm": cb}, role=role)
            servers.append(mgr)
            engines.append(cb)
        pre, dec = (tsvc.RemoteInferenceManager(
            f"127.0.0.1:{m.server.bound_port}") for m in servers)
        assert pre.server_status().role == "prefill"
        for kw in (dict(), MODES["device"]):
            want = _stream(tsvc, tside, "lm", steps=10, **kw)
            first, blob = tsvc.GenerateStreamClient(
                pre, "lm").prefill_export(PROMPT, **kw)
            assert first == want[0] and blob
            fills = engines[1].prompt_fills
            got = list(tsvc.GenerateStreamClient(dec, "lm").generate(
                PROMPT, 10, kv_shipment=blob, **kw))
            assert got == want
            assert engines[1].prompt_fills == fills    # zero prefills
            bad = bytearray(blob)
            bad[len(bad) // 2] ^= 0xFF
            again = list(tsvc.GenerateStreamClient(dec, "lm").generate(
                PROMPT, 10, kv_shipment=bytes(bad), **kw))
            assert again == want
            assert engines[1].prompt_fills == fills + 1  # local prefill
        pre.close()
        dec.close()
    finally:
        for m in servers:
            m.shutdown()
        for cb in engines:
            cb.shutdown()


# -- chaos sites --------------------------------------------------------------
SITES = [("rpc.stream", "lm"), ("rpc.server.generate_token", "dense"),
         ("rpc.client.unary", None), ("rpc.client.stream_recv", "lm"),
         ("serving.admission", "lm"), ("engine.step", "dense")]


def _outcome(client, side, engine, stall_s):
    remote = side.remote(client)
    toks = []
    try:
        if engine is None:
            r = remote.health(timeout=0.5)
            return ("ok", r.live, r.ready)
        for t in client.GenerateStreamClient(remote, engine).generate(
                PROMPT, 6, timeout=60, ttft_timeout=stall_s,
                inter_token_timeout=stall_s):
            toks.append(t)
        return ("ok", toks)
    except client.ResourceExhausted as e:
        return ("exhausted", e.retry_after_ms, toks)
    except client.GenerationRejected as e:
        return ("rejected", client.pb.StatusCode.Name(e.code), toks)
    except client.StreamStalled as e:
        return ("stalled", e.phase, toks)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return (type(e).__name__, toks)
    finally:
        remote.close()


@pytest.mark.chaos
@pytest.mark.parametrize("action", ["error", "drop"])
@pytest.mark.parametrize("site,engine", SITES)
def test_chaos_site_outcome_matches_tpulab(sides, site, engine, action):
    outcomes = []
    # a stalled stream is the expected end only of an rpc.stream drop;
    # elsewhere a generous bound keeps a slow first call from reading as
    # a stall
    stall_s = 1.0 if (site, action) == ("rpc.stream", "drop") else 60.0
    for side in sides:
        if engine is not None:      # warm: the shapes below are compiled
            _stream(side.svc, side, engine, steps=6)
        with side.chaos.inject(f"{site}={action}+1", seed=3) as sched:
            out = _outcome(side.svc, side, engine, stall_s)
            fired = sched.fired(site)
        outcomes.append((out, fired))
        if engine is not None:
            assert _lanes_home(side.engines[engine]), (side.name, out)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == 1          # the site was reached and fired
