"""The port's control-plane event journal against tpulab's, on the CPU.

The same events, nodes and clock through ``tpulab.obs.journal`` and
``tpulab_torch.obs.journal`` give equal records, byte-equal files, equal
replays (a torn trailing line skipped), the same sequence continued by a
reopened journal, the same ``sequence_gaps`` audit and the same counts of
written events and failed appends.
"""

import tpulab.obs.journal as J
import tpulab_torch.obs as tobs
import tpulab_torch.obs.journal as T


class _Clock:
    def __init__(self):
        self.t = 1_700_000_000.0

    def __call__(self):
        self.t += 0.125
        return self.t


EVENTS = [("replica_death", dict(address="10.0.0.1:5", evidence="exit",
                                 exit_code=86, recent_deaths=1,
                                 respawn_backoff_s=0.5)),
          ("replica_respawn", dict(lineage="10.0.0.1:5",
                                   address="10.0.0.3:7", respawns=1)),
          ("scale_up", dict(address="a", active=3, wait_ewma_s=0.612,
                            overload_delta=0)),
          ("drain_start", dict(address="b", wait_ewma_s=0.0,
                               overload_delta=0, slo_burn=1.25)),
          ("note", dict(payload={"nested": [1, 2.5, None]},
                        tags={"x"}, text="ü\n\"q\""))]


def _write(mod, path):
    clk = _Clock()
    out = []
    with mod.EventJournal(path, node="ctl-a", clock=clk) as jr:
        for kind, fields in EVENTS:
            out.append(jr.record(kind, **fields))
        assert jr.events_written == len(EVENTS)
        assert set(jr.append_quantiles()) == {"p50", "p99"}
        assert [e["kind"] for e in jr.events("scale_up")] == ["scale_up"]
    # a second writer lineage and a reopened first lineage, interleaved
    with mod.EventJournal(path, node="ctl-b", clock=clk) as other:
        out.append(other.record("lease_acquire", token=2))
    with mod.EventJournal(path, node="ctl-a", clock=clk) as again:
        out.append(again.record("scale_down", address="b", drain_ok=True))
    return out


def test_records_files_and_replays_equal_tpulab(tmp_path):
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    want, got = _write(J, jp), _write(T, tp)
    assert got == want
    assert [e["seq"] for e in got] == [1, 2, 3, 4, 5, 1, 6]
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    for path in (jp, tp):                  # a torn trailing write
        with open(path, "a") as f:
            f.write('{"seq": 7, "kind": "sca')
    replay = T.replay_journal(tp)
    assert replay == J.replay_journal(jp)
    # a value JSON cannot hold is written as its str()
    assert replay == [dict(e, tags=str(e["tags"])) if "tags" in e else e
                      for e in got]
    assert T.sequence_gaps(got) == J.sequence_gaps(want) == []
    assert tobs.replay_journal is T.replay_journal
    assert T.replay_journal(str(tmp_path / "missing")) == []


def test_sequence_gaps_equal_tpulab():
    events = [{"node": "a", "seq": 1}, {"node": "b", "seq": 4},
              {"node": "a", "seq": 2}, {"node": "a", "seq": 4},
              {"node": "b", "seq": 5}, {"seq": 3}, {"seq": 3},
              {"node": "b", "seq": 5}]
    assert T.sequence_gaps(events) == J.sequence_gaps(events)
    assert T.sequence_gaps(events) == [("a", 4, 3), ("", 3, 4),
                                       ("b", 5, 6)]


def test_append_failure_on_a_directory_is_counted_not_raised(tmp_path):
    """A path that cannot be opened for append (a directory) fails every
    record: None returned, ``append_errors`` counted, as in tpulab."""
    got = []
    for mod in (J, T):
        jr = mod.EventJournal(str(tmp_path), node="n")
        got.append(([jr.record("k"), jr.record("k")], jr.append_errors,
                    jr.events_written))
        jr.close()
    assert got[0] == got[1] == ([None, None], 2, 0)
