"""The port's request tracing against tpulab's (``utils/tracing.py``):
trace ids and their metadata, recovery from a request or its metadata,
the Chrome-trace recorder's ring and file, the merge of two processes'
traces; and the profiler hooks on ``torch.profiler`` (a CPU run here:
the card's run adds CUDA activity)."""

import json
import types

import torch

from tpulab.utils import tracing as jtr
from tpulab_torch.utils import tracing as ttr


def test_trace_context_matches_tpulab():
    assert ttr.TRACE_METADATA_KEY == jtr.TRACE_METADATA_KEY
    tid = ttr.mint_trace_id()
    assert len(tid) == 16 and int(tid, 16) >= 0
    for mod in (jtr, ttr):
        tc = mod.TraceContext("ab12")
        assert tc.metadata() == (("tpulab-trace-id", "ab12"),)
        req = types.SimpleNamespace(trace_id="")
        ctx = types.SimpleNamespace(
            invocation_metadata=lambda: (("tpulab-trace-id", "m9"),))
        assert mod.TraceContext.of_request(req, ctx).trace_id == "m9"
        assert mod.TraceContext.of_request(types.SimpleNamespace(
            trace_id="r1"), ctx).trace_id == "r1"
        assert mod.TraceContext.of_request(req) is None


def test_recorder_ring_file_and_merge_match_tpulab(tmp_path):
    docs = {}
    for name, mod in (("jax", jtr), ("torch", ttr)):
        rec = mod.ChromeTraceRecorder(max_events=3, process_name=name)
        t0 = rec._t0
        for i in range(5):
            rec.add_span(f"s{i}", t0 + i * 1e-3, 5e-4, tid=1, model="m")
        rec.add_counter("decode_block", t0, tokens=8, k=8)
        assert len(rec) == 3 and rec.dropped_events == 3
        path = rec.save(str(tmp_path / f"{name}.json"))
        doc = json.load(open(path))
        for ev in doc["traceEvents"]:
            ev.pop("pid", None)
        docs[name] = doc
    assert docs["jax"]["traceEvents"][1:] == docs["torch"]["traceEvents"][1:]
    assert docs["torch"]["otherData"]["dropped_events"] == 3
    out = ttr.merge_chrome_traces(str(tmp_path / "merged.json"),
                                  str(tmp_path / "jax.json"),
                                  str(tmp_path / "torch.json"))
    merged = json.load(open(out))
    assert merged["otherData"]["merged_from"] == 2
    assert len(merged["traceEvents"]) == 2 * len(docs["torch"]["traceEvents"])


def test_profiler_trace_annotate_and_stage_timer(tmp_path):
    t = ttr.StageTimer()
    with ttr.trace(str(tmp_path / "prof")) as d:
        with ttr.annotate("matmul-region"):
            with t.stage("compute", sync_on_fn=lambda: y):
                y = torch.ones(64, 64) @ torch.ones(64, 64)
        t.sync("compute", [y, {"y": y}])
    trace = json.load(open(f"{d}/trace.json"))
    assert any(e.get("name") == "matmul-region"
               for e in trace["traceEvents"])
    assert set(t.stages_ms) == {"compute"} and t.total_ms > 0



def test_profiler_session_refused_while_any_thread_profiles():
    """The process's one profiler session: a bare ``torch.profiler``
    session opened on another thread makes ``profiler_session`` and
    ``claim_profiler`` refuse; both work again once it closes."""
    import threading

    import pytest
    from torch.profiler import ProfilerActivity, profile

    opened, close = threading.Event(), threading.Event()

    def bare():
        with profile(activities=[ProfilerActivity.CPU]):
            opened.set()
            close.wait(30)

    th = threading.Thread(target=bare)
    th.start()
    try:
        assert opened.wait(30)
        assert ttr.profiler_running()
        assert not ttr.claim_profiler("probe")
        with pytest.raises(RuntimeError, match="already armed"):
            with ttr.profiler_session(activities=[ProfilerActivity.CPU]):
                pass
    finally:
        close.set()
        th.join(30)
    assert not ttr.profiler_running()
    with ttr.profiler_session(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8) + 1
    assert ttr.device_event_count(prof) == 0


def test_profiler_session_without_cuda_activity_raises(monkeypatch):
    """A session that asks for the card's activity of a torch.profiler
    that cannot take it raises instead of tracing the CPU alone, and
    takes no claim."""
    import pytest
    import torch.profiler
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace CUDA"):
        with ttr.profiler_session(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]):
            pass
    assert ttr.claim_profiler("probe")
    ttr.release_profiler("probe")

def _batcher_spans(cb, rec, kv_offload=False):
    """Three requests admitted in one pass (the third queued behind the
    two lanes) and a preempting priority arrival; the recorder's spans as
    (name, row, untimed args) and its decode_block counters."""
    import numpy as np

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, (n,), np.int32) for n in (6, 20, 9)]
    held = {}

    def hook(tok, i):
        if i == 5 and "hi" not in held:
            held["hi"] = cb.submit(prompts[2][:4], 5, priority=10,
                                   trace_id="h" * 16)

    with cb._cv:
        futs = [cb.submit(prompts[0], 14, on_token=hook, trace_id="a" * 16),
                cb.submit(prompts[1], 9, trace_id="b" * 16),
                cb.submit(prompts[2], 7)]
    toks = [list(map(int, f.result(timeout=120))) for f in futs]
    toks.append(list(map(int, held["hi"].result(timeout=120))))
    timed = {"ts", "dur"}
    spans = sorted(
        (e["name"], e["tid"], json.dumps(
            {k: v for k, v in e.get("args", {}).items() if k not in timed},
            sort_keys=True))
        for e in rec._events if e["ph"] == "X")
    counters = [(e["name"], e["args"]) for e in rec._events
                if e["ph"] == "C"]
    return [len(t) for t in toks], spans, counters


def test_batcher_spans_match_tpulab():
    """The same requests through tpulab's batcher and the port's (ragged
    plan, host KV tier on) with a ChromeTraceRecorder on ``trace=``: the
    same spans — queue_wait, prefill, decode chunks, swap_out / swap_in —
    on the same lane rows with the same token counts, trace ids, block
    sizes and cached pages, and the same ``decode_block`` counters."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpulab.engine.paged import ContinuousBatcher as JBatcher
    from tpulab.models.transformer import init_transformer_params
    from tpulab_torch.engine.paged import ContinuousBatcher as TBatcher
    from tpulab_torch.models.convert import params_from_numpy

    torch.set_num_threads(2)
    p = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                           n_heads=2)
    cfg = dict(n_heads=2, n_layers=2, lanes=2, max_len=64, page_size=8,
               decode_block=4, prefill_chunk=16, kv_offload=True)
    out = {}
    for name, make, mod in (
            ("tpulab", lambda tr: JBatcher(p, compute_dtype=jnp.float32,
                                           use_kernel=False, ragged=True,
                                           trace=tr, **cfg), jtr),
            ("port", lambda tr: TBatcher(tp, compute_dtype=torch.float32,
                                         device="cpu", ragged=True,
                                         trace=tr, **cfg), ttr)):
        rec = mod.ChromeTraceRecorder()
        cb = make(rec)
        try:
            out[name] = _batcher_spans(cb, rec)
        finally:
            cb.shutdown()
    lens, spans, counters = out["port"]
    assert lens == [14, 9, 7, 5]
    names = {s[0] for s in spans}
    assert {"queue_wait", "prefill", "decode", "swap_out",
            "swap_in"} <= names
    assert counters and all(c[0] == "decode_block" for c in counters)
    assert out["port"] == out["tpulab"]
