"""The readers of the loop's own record (``spans.py``) on marks, spans and
intervals made by hand; the clock anchor in a CPU profiler window; and the
probe that reads them (``probes/loop_spans.py``) on a tiny cell."""

import json
import os
import subprocess
import sys
import time

import pytest

from uvbench import spans, testing


def _marks(submit, *gaps):
    """A turn's marks: ``submit`` then each stage's seconds in turn."""
    out, t = {"submit_time": submit}, submit
    for field, gap in zip(spans.MARKS[1:], gaps):
        t += gap
        out[field] = t
    return out


def test_stage_shares_split_the_ttft():
    marks = [_marks(10.0, 0.1, 0.2, 0.3, 0.05, 0.35), _marks(11.0, 0.0, 0.2, 0.0, 0.05, 0.75)]
    secs = spans.stage_seconds(marks)
    assert secs["queue"] == pytest.approx([0.1, 0.0])
    assert secs["inflight"] == pytest.approx([0.35, 0.75])
    shares = spans.stage_shares(marks)
    assert list(shares) == ["queue", "admit", "prefill_wait", "prefill", "inflight"]
    assert shares["queue"] == pytest.approx(5.0) and shares["inflight"] == pytest.approx(55.0)
    assert sum(shares.values()) == pytest.approx(100.0)
    assert spans.stage_shares([]) is None


def test_idle_gap_split_across_three_loop_spans():
    """Device busy [0, 100) and [400, 500) in a window [0, 600): idle
    [100, 400) and [500, 600). The loop: a tick [50, 450) holding a
    decode dispatch [60, 150), a fetch [200, 350) with its readback [210,
    330), and a wait [360, 440); the next tick [460, 520)."""
    rows = [("tick", 50, 450, -1, -1, 0), ("decode_dispatch", 60, 150, 0, -1, 4),
            ("fetch", 200, 350, 0, -1, 0), ("readback", 210, 330, 2, -1, 0),
            ("wait", 360, 440, 0, -1, 0), ("tick", 460, 520, -1, -1, 0)]
    segs = spans.innermost(rows, offset=0)
    assert segs == [(50, 60, "tick"), (60, 150, "decode_dispatch"), (150, 200, "tick"),
                    (200, 210, "fetch"), (210, 330, "readback"), (330, 350, "fetch"),
                    (350, 360, "tick"), (360, 440, "wait"), (440, 450, "tick"), (460, 520, "tick")]
    busy = spans.merged([(400, 450), (0, 60), (40, 100), (430, 500)])
    assert busy == [(0, 100), (400, 500)]
    idle = spans.idle_stretches(busy, 0, 600)
    assert idle == [(100, 400), (500, 600)]
    by = spans.idle_by_state(idle, segs)
    assert by == {"decode_dispatch": 50, "tick": 80, "fetch": 30, "readback": 120, "wait": 40,
                  spans.OUTSIDE: 80}
    assert sum(by.values()) == 400
    assert spans.host_bound_share(by) == pytest.approx(100.0 * (400 - 160) / 400)
    # moved onto another clock, the same spans give the same split
    moved = spans.innermost([(n, s - 7, t - 7, p, r, v) for n, s, t, p, r, v in rows], offset=7)
    assert spans.idle_by_state(idle, moved) == by


def test_window_edges_and_empty_record():
    assert spans.idle_stretches([], 5, 9) == [(5, 9)]
    assert spans.idle_stretches([(0, 20)], 5, 9) == []
    assert spans.idle_stretches([(0, 6), (8, 12)], 5, 9) == [(6, 8)]
    assert spans.idle_by_state([(5, 9)], []) == {spans.OUTSIDE: 4}
    assert spans.host_bound_share({}) is None


def test_innermost_host_op_of_each_gap():
    host = sorted([(0, 100, "outer"), (10, 20, "short"), (30, 90, "mid"), (95, 200, "late")])
    assert spans.innermost_host_op(host, [5, 15, 50, 97, 150, 300]) == [
        "outer", "short", "mid", "outer", "late", None]


def test_anchor_places_a_span_on_the_profilers_clock():
    """In a window of the harness's own profiler (``trace.Trace``), a
    record_function emitted inside a span of the program's recorder lands
    inside that span once the span is moved by the anchor's offset."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function

    from ultravox_torch.inference.serving.spans import SpanRecorder
    from uvbench.trace import Trace

    rec = SpanRecorder()
    tr = Trace()
    tr.prepare()
    tr.begin()
    with record_function(spans.CLOCK_EVENT):
        reading = time.monotonic_ns()
    time.sleep(0.002)
    i = rec.open("decode_dispatch")
    time.sleep(0.001)
    with record_function("inside"):
        torch.ones(8).sum()
    time.sleep(0.001)
    rec.close(i)
    time.sleep(0.002)
    tr.stop()
    start = {e.name(): e.start_ns() for e in tr._result.events()
             if e.device_type() == DeviceType.CPU}
    offset = spans.clock_offset(start[spans.CLOCK_EVENT], reading)
    (_, s, t, *_), = rec.rows()
    assert s + offset <= start["inside"] <= t + offset
    assert t - s < 10_000_000  # the span is a few milliseconds long


def test_probe_on_a_tiny_cell(tmp_path):
    """The probe's run on the CPU: the harness's result line with the
    probe's readings among the per-layer metrics, and its log lines."""
    root = testing.tiny_checkout(tmp_path)
    cmd = [sys.executable, "uvbench/probes/loop_spans.py", "--workload", "tiny-chat", "--seed",
           str(2**31 + 17), "--seconds", "8", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    m = result["metrics"]
    shares = [m[f"ttft_{s}_share"]["value"] for s, _, _ in spans.STAGES]
    assert sum(shares) == pytest.approx(100.0, abs=1e-6)
    assert 0 <= m["idle_host_bound_share"]["value"] <= 100
    assert m["admit_share"]["value"] > 0 and m["prefill_dispatch_share"]["value"] > 0
    err = out.stderr
    assert "traced idle" in err and " 0 dropped" in err and "ns a span" in err
    assert "decode steps a second" in err
