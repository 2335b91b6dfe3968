"""The serving loop's spans and request marks in one traced run of a
serving cell, read against the device trace.

    python3 uvbench/probes/loop_spans.py --workload <cell> --seed N --seconds S [--spans 0]

from the root of a checkout, on the card. It runs the cell as
``uvbench/run.py --trace 1`` does and adds, from outside the harness's
files: the engine's span recorder (``ServingEngine.spans``), set when the
window opens (not with ``--spans 0``); a clock anchor taken inside a
``record_function`` (``spans.CLOCK_EVENT``) as the traced stretch opens;
the merged device intervals and every host operation of the trace, taken
before the harness reduces it; and the engine's ``stat_admit_s`` and
``stat_prefill_s`` beside the counters the harness reads. The readings
(``uvbench/spans.py``) join the per-layer metrics of the result line:

- ``ttft_<stage>_share``, the five stages (queue, admit, prefill_wait,
  prefill, inflight) summed over the turns due in the window that finished
  whole with their first token emitted before the traced stretch opened,
  over their engine TTFT (first emit less submit) summed;
- ``idle_host_bound_share``, the traced idle time in which the loop was in
  neither ``wait`` nor ``readback``, over all of it;
- ``admit_share`` and ``prefill_dispatch_share``, the counters' growth over
  the traced stretch's length.

Standard error gets each stage's median and p95, the engine's summed TTFT
against the harness's (first token less due), the traced idle seconds by
the loop's innermost span, the share of traced idle whose gap's innermost
host operation is the profiler's own (``Activity_Buffer_Request``), the
spans a second, the buffer's drops, and the recorder's cost a span on this
host."""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from uvbench import run as harness  # noqa: E402  (first: its clock starts at import)
from uvbench import spans as readers  # noqa: E402
from uvbench import spec, trace  # noqa: E402
from uvbench.stats import percentile  # noqa: E402

EXTRA_COUNTERS = ("stat_admit_s", "stat_prefill_s")
PROFILER_OWN = "Activity Buffer Request"  # CUPTI handing the profiler its buffers


class _Probe:
    """What the run leaves for the readers: the engine, the anchor, the
    trace's intervals and host operations."""

    engine = None
    recorder = None
    spans_on = True
    anchor = None  # (monotonic ns read inside CLOCK_EVENT, the window's start in monotonic ns)
    anchor_start_ns = None  # CLOCK_EVENT's start on the profiler's clock
    busy = None
    host = None


def _patch_program():
    from ultravox_torch.inference.serving import engine as engine_lib

    class Engine(engine_lib.ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            _Probe.engine = self
            self.submitted = []

        def submit(self, *args, **kwargs):
            req = super().submit(*args, **kwargs)
            self.submitted.append(req)
            return req

    engine_lib.ServingEngine = Engine


def _patch_harness():
    from ultravox_torch.inference.serving.spans import SpanRecorder

    load_module = spec.load_module

    def load(kind, name):
        mod = load_module(kind, name)
        if kind == "entries":
            mod.COUNTERS = tuple(mod.COUNTERS) + EXTRA_COUNTERS
        return mod

    spec.load_module = load

    mark_setup_end = harness.Context.mark_setup_end

    def window_opens(ctx):
        mark_setup_end(ctx)
        if _Probe.spans_on and _Probe.engine is not None:
            _Probe.recorder = _Probe.engine.spans = SpanRecorder()

    harness.Context.mark_setup_end = window_opens

    class Trace(trace.Trace):
        def begin(self):
            from torch.autograd.profiler import record_function

            super().begin()
            with record_function(readers.CLOCK_EVENT):
                reading = time.monotonic_ns()
            _Probe.anchor = (reading, int(self._t0 * 1e9))

        def reduce(self):
            from torch.autograd import DeviceType

            dev, host = [], []
            for e in self._result.events():
                s = e.start_ns()
                if e.device_type() == DeviceType.CUDA:
                    dev.append((s, s + e.duration_ns()))
                elif e.device_type() == DeviceType.CPU:
                    if e.name() == readers.CLOCK_EVENT:
                        _Probe.anchor_start_ns = s
                    elif e.duration_ns() > 0:
                        host.append((s, s + e.duration_ns(), e.name()))
            host.sort()
            _Probe.busy, _Probe.host = readers.merged(dev), host
            super().reduce()

    trace.Trace = Trace

    read_metrics = harness.Context.read_metrics

    def read(ctx, run):
        out = read_metrics(ctx, run)
        try:
            out.update(_readings(run, ctx.log))
        finally:
            if _Probe.engine is not None:
                _Probe.engine.spans = None
            _Probe.engine = None  # the harness frees the pool before the reference runs
        return out

    harness.Context.read_metrics = read


def _marks(run, engine):
    """The marks of the turns the TTFT shares read, with each turn's TTFT
    as the harness stamped it."""
    # a turn's request holds a view of the turn's own prompt ids
    by_ids = {id(r.batch["input_ids"].base): r for r in engine.submitted}
    a = run.traced[0]
    marks, stamped = [], []
    for rec in run.due_in_window():
        req = by_ids.get(id(rec.ids))
        if not rec.ok or rec.first >= a or req is None:
            continue
        marks.append({f: getattr(req, f) for f in readers.MARKS})
        stamped.append(rec.first - rec.due)
    return marks, stamped


def _readings(run, log):
    out = {}
    engine = _Probe.engine
    if run.traced is None or engine is None:
        return out
    t0, t1 = run.traced
    for name, counter in (("admit_share", "stat_admit_s"),
                          ("prefill_dispatch_share", "stat_prefill_s")):
        out[name] = {"value": 100.0 * run.counter(counter) / (t1 - t0), "unit": "%"}
    marks, stamped = _marks(run, engine)
    shares = readers.stage_shares(marks)
    if shares:
        for name, secs in readers.stage_seconds(marks).items():
            log(f"ttft stage {name}: median {percentile(secs, 50) * 1e3!r} ms, p95 "
                f"{percentile(secs, 95) * 1e3!r} ms over {len(secs)} turns")
            out[f"ttft_{name}_share"] = {"value": shares[name], "unit": "%"}
        engine_s = sum(m["first_emit_time"] - m["submit_time"] for m in marks)
        log(f"ttft summed over {len(marks)} turns: engine {engine_s!r} s, harness (first token "
            f"less due) {sum(stamped)!r} s, difference {engine_s - sum(stamped)!r} s; the five "
            f"shares sum to {sum(shares.values())!r}")
    rec, tr = _Probe.recorder, run.trace
    if rec is None or _Probe.anchor is None or _Probe.anchor_start_ns is None:
        log("loop spans: not recorded")
        return out
    rows = rec.rows()
    offset = readers.clock_offset(_Probe.anchor_start_ns, _Probe.anchor[0])
    w0 = _Probe.anchor[1] + offset
    w1 = w0 + int(tr.window_s * 1e9)
    stretches = readers.idle_stretches(_Probe.busy, w0, w1)
    by_state = readers.idle_by_state(stretches, readers.innermost(rows, offset))
    idle_s = sum(b - a for a, b in stretches) * 1e-9
    log(f"traced idle {idle_s!r} s (idle_share's: {tr.window_s - tr.busy_s!r} s) by the loop's "
        "innermost span: " + ", ".join(f"{k} {v * 1e-9!r} s" for k, v in
                                       sorted(by_state.items(), key=lambda kv: -kv[1])))
    share = readers.host_bound_share(by_state)
    if share is not None:
        out["idle_host_bound_share"] = {"value": share, "unit": "%"}
    labels = readers.innermost_host_op(_Probe.host, [(a + b) // 2 for a, b in stretches])
    own = sum(b - a for (a, b), n in zip(stretches, labels) if n == PROFILER_OWN) * 1e-9
    log(f"traced idle in gaps whose innermost host operation is {PROFILER_OWN}: {own!r} s of "
        f"{idle_s!r} s")
    a, b = t0 * 1e9, t1 * 1e9
    in_stretch = sum(1 for r in rows if a <= r[1] < b)
    log(f"loop spans: {len(rows)} recorded from the window's opening, {in_stretch / (t1 - t0)!r} "
        f"a second in the traced stretch, {rec.dropped} dropped")
    # what the profiler costs the loop: its decode steps a second before
    # the traced stretch (the recorder on, the profiler off) and in it
    before, during = (
        sum(r[5] for r in rows if r[0] == "decode_dispatch" and lo <= r[1] < hi) * 1e9
        / max(hi - lo, 1)
        for lo, hi in ((run.w0 * 1e9, a), (a, b)))
    log(f"decode steps a second: {before!r} before the traced stretch, {during!r} in it")
    return out


def span_cost_ns(n: int = 200_000) -> float:
    """Nanoseconds of one span's open and close on this host, with the
    clock readings a counted site takes."""
    from ultravox_torch.inference.serving.spans import SpanRecorder

    rec = SpanRecorder(capacity=n)
    t = time.perf_counter_ns()
    for _ in range(n):
        t0 = time.monotonic_ns()
        i = rec.open("fetch", -1, t0)
        rec.close(i, 0, time.monotonic_ns())
    spent = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        t0 = time.monotonic_ns()
        time.monotonic_ns() - t0
    return spent - (time.perf_counter_ns() - t) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args, rest = ap.parse_known_args(argv)
    _Probe.spans_on = bool(args.spans)
    _patch_program()
    _patch_harness()
    code = harness.main([*rest, "--trace", "1"])
    harness.log(f"recorder: {span_cost_ns()!r} ns a span (open and close) beyond the counters' "
                "clock readings, on this host")
    return code


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
