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
