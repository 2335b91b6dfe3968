"""The serving loop's request marks and spans (``ServingEngine.spans``,
``inference/serving/spans.py``) on the CPU, on the tiny engine of
tests/test_torch_serving.py.

Every request's marks are ordered, its five stages (queue, admit,
prefill_wait, prefill, inflight) sum to its TTFT and the terminal event's
``ttft_s`` is that TTFT, in slots and paged modes, single steps and blocks.
With a recorder set, every span lies inside its parent and bears a known
name, and each counter of host time equals the sum of its spans. A request
admitted while others decode waits in ``_inflight`` behind a decode
dispatch. With no recorder nothing is recorded and the counters still
advance. The recorder's buffer bound, and its closing of spans an
exception left open.
"""

import time

import numpy as np
import pytest

from tests.test_torch_serving import _batch, _engine
from tests.torch_parity import make_configs, make_params
from ultravox_torch.inference.serving.spans import NAMES, SpanRecorder

MARKS = ("submit_time", "admit_time", "admitted_time", "prefill_start_time", "first_token_time",
         "first_emit_time", "finish_time")
# span name -> the engine counter of host time that sums its spans
COUNTED = {"admit": "stat_admit_s", "prefill_chunk": "stat_prefill_s",
           "decode_dispatch": "stat_dispatch_s", "spec_dispatch": "stat_dispatch_s",
           "spec_sync": "spec_sync_s", "fetch": "stat_fetch_wait_s"}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = make_configs()
    _, tparams = make_params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    comp = jcfg.audio_token_compression
    batches = [_batch(rng, 20), _batch(rng, 33, 1.5, comp), _batch(rng, 9)]
    return tcfg, tparams, batches


def _finish(engine, req):
    """The request's tokens and its terminal event."""
    ids = []
    for ev in engine.stream(req, timeout=120):
        if ev.token_id is None:
            return ids, ev
        ids.append(ev.token_id)


def _serve(engine, batches, max_tokens=8):
    engine.start()
    try:
        reqs = [engine.submit(dict(b), max_tokens=max_tokens) for b in batches]
        out = [_finish(engine, r) for r in reqs]
    finally:
        engine.stop()
    return reqs, out


def _check_marks(req, end):
    marks = [getattr(req, m) for m in MARKS]
    assert None not in marks, dict(zip(MARKS, marks))
    assert marks == sorted(marks), dict(zip(MARKS, marks))
    stages = [b - a for a, b in zip(marks[:5], marks[1:6])]
    ttft = req.first_emit_time - req.submit_time
    assert sum(stages) == pytest.approx(ttft, rel=1e-9, abs=1e-9)
    assert end.ttft_s == ttft


@pytest.mark.parametrize("block_steps", [1, 4])
@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_marks_are_ordered_and_stages_sum_to_ttft(setup, mode, block_steps):
    tcfg, tparams, batches = setup
    eng = _engine(tparams, tcfg, cache_mode=mode, decode_block_steps=block_steps)
    reqs, out = _serve(eng, batches)
    for req, (ids, end) in zip(reqs, out):
        assert end.finish_reason == "length" and len(ids) == 8
        _check_marks(req, end)


def _check_nesting(rows):
    for name, start, end, parent, rid, value in rows:
        assert name in NAMES and start <= end
        if parent >= 0:
            p = rows[parent]
            assert p[1] <= start and end <= p[2], (name, p[0])
        else:  # the drain at the loop's exit fetches outside a tick
            assert name in ("tick", "fetch"), name
        if name in ("admit", "embed", "prefill_chunk"):
            assert rid >= 0
        if name == "embed":
            assert rows[parent][0] == "admit" and rows[parent][4] == rid
        if name in ("readback", "emit"):
            assert rows[parent][0] == "fetch"


@pytest.mark.parametrize("mode,kw", [
    ("slots", {"decode_block_steps": 1}),
    ("paged", {"decode_block_steps": 4}),
    ("paged", {"spec_decode": "ngram", "spec_k": 4, "spec_min_accept": 0}),
])
def test_spans_nest_and_sum_to_their_counters(setup, mode, kw):
    tcfg, tparams, batches = setup
    eng = _engine(tparams, tcfg, cache_mode=mode, **kw)
    eng.spans = rec = SpanRecorder()
    reqs, out = _serve(eng, batches, max_tokens=12)
    assert [end.finish_reason for _, end in out] == ["length"] * 3
    rows = rec.rows()
    assert rec.dropped == 0 and rows
    _check_nesting(rows)
    names = {r[0] for r in rows}
    assert {"tick", "admit", "embed", "prefill_chunk", "fetch", "readback", "emit", "wait"} <= names
    if "spec_decode" in kw:
        assert eng.spec_dispatches > 0 and "spec_dispatch" in names
    else:
        assert "decode_dispatch" in names
    for counter in set(COUNTED.values()):
        spans_s = sum(r[2] - r[1] for r in rows if COUNTED.get(r[0]) == counter) * 1e-9
        assert spans_s == pytest.approx(getattr(eng, counter), rel=1e-9, abs=1e-12), counter
    assert sum(1 for r in rows if r[0] == "prefill_chunk") == eng.stat_prefill_chunks
    assert sum(r[5] for r in rows if r[0] == "decode_dispatch") == eng.stat_decode_steps
    # each request's first chunk starts at its prefill_start mark
    for req in reqs:
        first = min(r[1] for r in rows if r[0] == "prefill_chunk" and r[4] == req.request_id)
        assert first * 1e-9 == pytest.approx(req.prefill_start_time, abs=1e-6)


def test_a_request_admitted_while_others_decode_waits_in_flight(setup):
    """The late request's first token is sampled at the end of its last
    chunk, then waits in ``_inflight`` behind at least one decode dispatch
    before it is handed out."""
    tcfg, tparams, batches = setup
    eng = _engine(tparams, tcfg, cache_mode="paged", decode_block_steps=4)
    eng.spans = rec = SpanRecorder()
    eng.start()
    try:
        early = eng.submit(dict(batches[0]), max_tokens=60)
        events = eng.stream(early, timeout=120)
        assert next(events).token_id is not None  # decoding now
        late = eng.submit(dict(batches[2]), max_tokens=4)
        late_ids, late_end = _finish(eng, late)
        rest = list(events)
    finally:
        eng.stop()
    assert late_end.finish_reason == "length" and len(late_ids) == 4
    assert rest[-1].finish_reason == "length"
    _check_marks(late, late_end)
    assert late.first_emit_time > late.first_token_time
    a, b = late.first_token_time * 1e9, late.first_emit_time * 1e9
    assert any(r[0] == "decode_dispatch" and a <= r[1] <= b for r in rec.rows())
    assert late.admit_time < early.finish_time  # admitted while the other decoded


def test_no_recorder_records_nothing_and_counters_advance(setup):
    tcfg, tparams, batches = setup
    eng = _engine(tparams, tcfg, cache_mode="paged", decode_block_steps=4)
    eng.spans = rec = SpanRecorder()
    eng.start()
    try:
        req = eng.submit(dict(batches[0]), max_tokens=4)
        _finish(eng, req)
        eng.spans = None
        time.sleep(0.05)  # the loop's tick in progress ends
        n = len(rec.rows())
        counters = {c: getattr(eng, c) for c in set(COUNTED.values())}
        reqs = [eng.submit(dict(b), max_tokens=6) for b in batches]
        out = [_finish(eng, r) for r in reqs]
    finally:
        eng.stop()
    assert [end.finish_reason for _, end in out] == ["length"] * 3
    assert len(rec.rows()) == n
    for c in ("stat_admit_s", "stat_prefill_s", "stat_dispatch_s", "stat_fetch_wait_s"):
        assert getattr(eng, c) > counters[c], c
    for req, (_, end) in zip(reqs, out):
        _check_marks(req, end)


def test_recorder_bound_and_spans_left_open():
    rec = SpanRecorder(capacity=3)
    tick = rec.open("tick", start=10)
    fetch = rec.open("fetch", start=11)
    rec.open("readback", start=12)  # an exception skips its close
    rec.close(fetch, end=15)
    assert rec.open("emit", start=16) == -1 and rec.dropped == 1
    rec.close(-1, end=17)  # a dropped span's close does nothing
    rec.close(tick, 2, end=20)
    assert rec.rows() == [("tick", 10, 20, -1, -1, 2), ("fetch", 11, 15, 0, -1, 0),
                          ("readback", 12, 15, 1, -1, 0)]

