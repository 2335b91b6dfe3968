"""Serving cells: ``ServingEngine.submit`` / ``stream`` under a traffic mix.

Set-up builds the port's kernels (once per checkout), makes the weights on
the device from the seed, builds the engine with the cell's options, warms
every mel bucket the traffic can send and, where the mix has agents,
prefills their system prompts (the traffic needs them cached). Then the
traffic runs: a scheduler thread submits each turn when it is due, and
one collector thread takes every turn's tokens, each stamped with the time
the engine delivered it. After ``ramp_s`` the measured
window opens; it closes ``--seconds`` later. Every turn due inside it is
waited for (at most ``WAIT_S`` past the close, or past the end of the
profiler's stop in a traced run) with the traffic still
running, so its conditions hold to its end; a traced run, which reports no
latency, sends nothing due after the close, since stopping the profiler
stalls the engine for some 20-30 s. Then the engine stops, the
peak memory is read, the program's state is freed, and the reference
checks a sample of the window's finished turns (``reference/serve_check.py``).
"""

from __future__ import annotations

import gc
import heapq
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from uvbench import traffic as traffic_lib
from uvbench import program
from uvbench import weights as weights_lib

# a traced run's turns wait out the profiler's stop (20-30 s) and then a
# backlog decoding in single steps: the last has finished 58 s after the
# stop's end on an H100
WAIT_S = 120.0
TRACE_S = 6.0  # the traced stretch: the end of the window
COUNTERS = ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks",
            "stat_fetch_wait_s", "stat_dispatch_s", "reused_prefix_tokens")


@dataclass
class TurnRecord:
    due: float
    ids: np.ndarray
    start: int
    n_audio: int
    turn: traffic_lib.Turn
    submit: float = 0.0
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    finish: Optional[str] = None
    prompt_len: int = 0
    reused: int = 0
    req: Any = None  # the engine's request, until it finishes
    tap: Any = None
    session: Any = None

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    @property
    def ok(self) -> bool:
        return self.finish == "length" and len(self.tokens) == self.turn.max_tokens


class _Tap:
    """A request's event queue, the one ``ServingEngine.stream`` reads: each
    event goes, stamped with the time the engine hands it over, to the
    load's one collector (one thread for every turn, where a ``stream``
    reader a turn would put some hundred threads beside the engine's).

    It takes the place of the request's own queue once ``submit`` has
    returned, so the engine may have put an event into that one, or be
    putting one: every event forwards what the old queue holds first, under
    a lock, so none is lost and all stay in the engine's order."""

    def __init__(self, sink: "queue.SimpleQueue", rec: "TurnRecord", old: "queue.Queue"):
        self._sink, self._rec, self._old = sink, rec, old
        self._lock = threading.Lock()

    def flush(self) -> None:
        with self._lock:
            self._drain()

    def _drain(self) -> None:
        while True:
            try:
                ev = self._old.get_nowait()
            except queue.Empty:
                return
            self._sink.put((self._rec, time.monotonic(), ev))

    def put(self, ev, *args, **kwargs) -> None:
        with self._lock:
            self._drain()
            self._sink.put((self._rec, time.monotonic(), ev))


class Load:
    """Submits each session's turns when due; one collector thread reads
    every turn's tokens as the engine delivers them."""

    def __init__(self, engine, plan: traffic_lib.Plan):
        self.engine, self.plan = engine, plan
        self.records: List[TurnRecord] = []
        self._heap: list = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._submitting = 0
        self._cutoff = float("inf")
        self._sink: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._schedule, daemon=True)
        self._collector = threading.Thread(target=self._collect, daemon=True)

    def start(self, t0: float) -> None:
        for s in self.plan.sessions:
            t = self.plan.next_turn(s)
            if t is not None:
                self._push(t0 + s.start_s, s, t)
        self._collector.start()
        self._thread.start()

    def _push(self, due: float, s, t) -> None:
        with self._cv:
            heapq.heappush(self._heap, (due, next(self._seq), s, t))
            self._cv.notify()

    def _schedule(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (not self._heap or self._heap[0][0] > time.monotonic()):
                    wait = self._heap[0][0] - time.monotonic() if self._heap else None
                    self._cv.wait(timeout=wait)
                if self._stop:
                    return
                due, _, s, t = heapq.heappop(self._heap)
                if due >= self._cutoff:
                    continue
                self._submitting += 1  # popped, not yet in ``records``
            self._submit(due, s, t)

    def _submit(self, due: float, s, t) -> None:
        ids, start, n_audio, mel = self.plan.prompt(s, t)
        rec = TurnRecord(due, ids, start, n_audio, t)
        rec.session = s
        batch = request_batch(ids, start, n_audio, mel)
        rec.submit = time.monotonic()
        req = self.engine.submit(batch, max_tokens=t.max_tokens, temperature=0.0)
        rec.req = req
        rec.tap = tap = _Tap(self._sink, rec, req.out_queue)
        req.out_queue = tap
        tap.flush()
        with self._cv:
            self.records.append(rec)
            self._submitting -= 1

    def _collect(self) -> None:
        while True:
            item = self._sink.get()
            if item is None:
                return
            rec, t, ev = item
            if ev.token_id is not None:
                rec.times.append(t)
                rec.tokens.append(ev.token_id)
                continue
            rec.finish = ev.finish_reason
            req, rec.req = rec.req, None
            rec.prompt_len, rec.reused = req.prompt_len, req.reused_prefix
            if rec.finish != "length":
                continue  # the session ends with a failed turn
            s, turn = rec.session, rec.turn
            self.plan.finished(s, turn, rec.tokens)
            nxt = self.plan.next_turn(s)
            if nxt is not None and not self._stop:
                self._push(time.monotonic() + self.plan.wait_before(nxt), s, nxt)

    def close(self, t: float) -> None:
        """Send nothing due at ``t`` or later."""
        with self._cv:
            self._cutoff = t

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10)

    def join_clients(self, timeout: float) -> None:
        self._sink.put(None)
        self._collector.join(timeout=timeout)
        for rec in self.records:
            rec.req = rec.session = rec.tap = None


def request_batch(ids: np.ndarray, start: int, n_audio: int, mel: Optional[np.ndarray]) -> Dict:
    """One collated row as the engine takes it."""
    batch = {"input_ids": ids[None], "attention_mask": np.ones((1, ids.size), np.int64)}
    if mel is not None:
        batch.update({
            "audio_values": np.ascontiguousarray(mel, np.float32)[None],
            "audio_lens": np.array([mel.shape[-1]], np.int32),
            "audio_token_start_idx": np.array([start], np.int32),
            "audio_token_len": np.array([n_audio], np.int32),
            "audio_chunk_batch_idx": np.zeros(1, np.int32),
        })
    return batch


def _wait_all(engine, reqs, timeout: float = 600.0) -> None:
    for req in reqs:
        for ev in engine.stream(req, timeout=timeout):
            if ev.token_id is None:
                if ev.finish_reason not in ("length", "stop"):
                    raise RuntimeError(f"warm-up request finished {ev.finish_reason!r}")
                break


def warm_up(engine, plan: traffic_lib.Plan, buckets) -> None:
    """System prompts prefilled (they stay cached for the traffic), then
    one request per mel bucket the traffic's audio lengths reach (the
    longest length in it), sent together so decode runs in blocks and in
    single steps."""
    reqs = [engine.submit(request_batch(sp, 0, 0, None), max_tokens=2) for sp in plan.system]
    _wait_all(engine, reqs)
    frames, prev = [], 0
    for b in buckets:
        f = min(plan.max_frames, b) // 16 * 16
        if f >= max(plan.min_frames, prev + 1):
            frames.append(f)
        prev = b
    reqs = []
    for i, f in enumerate(frames):
        t = traffic_lib.Turn(f / traffic_lib.FRAMES_PER_S, f, 0, 24, np.zeros(0, np.int64))
        s = traffic_lib.Session(-1 - i, 0.0, 0 if plan.system else None, [])
        ids, start, n_audio, mel = plan.prompt(s, t)
        reqs.append(engine.submit(request_batch(ids, start, n_audio, mel), max_tokens=24))
    _wait_all(engine, reqs)


def snapshot(engine, load: Load) -> Dict[str, float]:
    out = {k: float(getattr(engine, k)) for k in COUNTERS}
    out["t"] = time.monotonic()
    # the backlog a sweep watches: turns submitted that have had no token yet
    out["queued"] = float(sum(1 for r in list(load.records) if not r.times and r.finish is None))
    return out


class PageLog:
    """``engine.pages_in_use`` sampled through the window: what the turns
    hold of the page pool, against what it reserves. It holds the engine:
    drop it with the engine."""

    def __init__(self, engine):
        self.engine, self.samples = engine, []

    def __call__(self) -> None:
        self.samples.append(self.engine.pages_in_use)

    def line(self) -> str:
        e, xs = self.engine, self.samples
        if not e.paged or not xs:
            return "pages in use: not sampled"
        return (f"pages in use over the window ({len(xs)} samples): mean {sum(xs) / len(xs):.1f}, "
                f"peak {max(xs)} of {e.num_pages} (pages of {e.page_size} positions)")


class ServeRun:
    """What the metric readers of a serving cell read."""

    kind = "serve"

    def __init__(self, m, settings, records, window, traced, counters, trace, log):
        self.m, self.records = m, records
        self.w0, self.w1 = window
        self.traced = traced  # (t0, t1) of the traced stretch, or None
        self.c0, self.c1 = counters
        self.trace = trace
        self.log = log
        self.chunk = settings["engine"].get("prefill_chunk_tokens", 256)

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    def due_in_window(self) -> List[TurnRecord]:
        return [r for r in self.records if self.w0 <= r.due < self.w1]

    def span(self):
        """The stretch the per-layer readers read: the traced one."""
        return self.traced if self.traced else (self.w0, self.w1)

    def counter(self, name: str) -> float:
        return self.c1[name] - self.c0[name]

    def prefilled_in_span(self) -> List[TurnRecord]:
        a, b = self.span()
        return [r for r in self.records if r.first is not None and a <= r.first < b]

    def decode_contexts_in_span(self) -> List[int]:
        """The keys each token decoded in the span attended to (the first
        token of a turn comes from its prefill)."""
        a, b = self.span()
        out = []
        for r in self.records:
            for j, tt in enumerate(r.times):
                if j and a <= tt < b:
                    out.append(r.prompt_len + j)
        return out


def run(ctx) -> Dict:
    import torch

    from ultravox_torch.inference.serving.engine import MEL_LEN_BUCKETS, ServingEngine

    cell, args = ctx.cell, ctx.args
    settings, cfgfile = cell["settings"], cell["config"]
    on_card = ctx.device.type == "cuda"
    if on_card:
        from ultravox_torch.ops.kernels import _build

        # every library, so no cell's kernel builds inside its window
        built = _build.build_all()
        ctx.log(f"kernels built or found: {sum(1 for v in built.values() if v['seconds'])} built "
                f"of {len(built)}")
    m = weights_lib.dims(cfgfile)
    cfg = program.program_config(cfgfile)
    dtype = weights_lib.DTYPES[cfgfile.get("dtype", "bfloat16")]
    w = weights_lib.make(cfgfile, args.seed, ctx.device, fused=True)
    tree = program.program_tree(w, cfgfile)
    del w
    engine = ServingEngine(tree, cfg, device=None if on_card else "cpu", cache_dtype=dtype,
                           **settings["engine"])
    del tree
    engine.start()
    plan = traffic_lib.Plan(cell["traffic"], m.V, m.n_mels, args.seed, args.seconds, args.rate)
    warm_up(engine, plan, engine.mel_len_buckets or MEL_LEN_BUCKETS)

    trace = None
    if args.trace:
        from uvbench.trace import Trace

        trace = Trace()
        trace.prepare()
    load = Load(engine, plan)
    t0 = time.monotonic()
    load.start(t0)
    w0 = t0 + plan.ramp_s
    w1 = w0 + args.seconds
    _sleep_until(w0)
    ctx.mark_setup_end()
    c_open = snapshot(engine, load)
    pages = PageLog(engine)
    traced = None
    if trace is not None:
        # the last TRACE_S of the window: reducing the trace comes after
        # the engine stops, so it cannot hold up the window's turns
        _sleep_until(max(w0, w1 - TRACE_S), pages)
        trace.begin()
        c0 = snapshot(engine, load)
        _sleep_until(w1, pages)
        c1 = snapshot(engine, load)
        # the profiler's stop holds the interpreter, the engine's loop with
        # it, for some 20-30 s: the turns held up by it would come in one
        # burst and keep the window's own from finishing, so nothing due
        # after the close is sent, and the turns' minute runs from its end
        load.close(w1)
        t_stop = time.monotonic()
        trace.stop()
        traced = (c0["t"], c1["t"])
        ctx.log(f"profiler stopped in {time.monotonic() - t_stop:.1f} s")
    else:
        c0 = c_open
        _sleep_until(w1, pages)
        c1 = snapshot(engine, load)
    deadline = max(w1, time.monotonic()) + WAIT_S
    while time.monotonic() < deadline:
        with load._cv:
            due = [r for r in load.records if w0 <= r.due < w1]
        for r in due:
            if r.finish is None and r.tap is not None:
                r.tap.flush()
        if all(r.finish is not None for r in due) and not _late_due(load, w1):
            break
        time.sleep(0.05)
    waited = time.monotonic() - w1
    load.stop()
    engine.stop()
    load.join_clients(timeout=30)
    ctx.read_memory_peak()
    if trace is not None:
        t_red = time.monotonic()
        trace.reduce()
        ctx.log(f"trace reduced in {time.monotonic() - t_red:.1f} s")
    stats = ServeRun(m, settings, load.records, (w0, w1), traced, (c0, c1), trace, ctx.log)
    due = stats.due_in_window()
    late = [r.submit - r.due for r in due]
    if late:
        late.sort()
        ctx.log(f"generator lateness over {len(late)} turns due in the window: median "
                f"{late[len(late) // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms")
    ctx.log(f"window: {len(due)} turns due, {sum(1 for r in due if r.ok)} finished, the last "
            f"{waited:.1f} s after the close; engine resolved {engine.resolved_flags}")
    for r in due:
        if not r.ok:
            ctx.log(f"turn not finished whole: due {r.due - w1:+.3f} s from the close, sent "
                    f"{(r.submit - r.due) * 1e3:.1f} ms late, finish {r.finish!r}, "
                    f"{len(r.tokens)} of {r.turn.max_tokens} tokens, first "
                    f"{'none' if r.first is None else f'{r.first - r.due:.3f} s'} after due, "
                    f"last {'none' if not r.times else f'{r.times[-1] - w1:+.3f} s'} from the close")
    steps = c1["stat_decode_steps"] - c0["stat_decode_steps"]
    disp = c1["stat_decode_dispatches"] - c0["stat_decode_dispatches"]
    if disp:
        ctx.log(f"serving loop in the window: {disp:.0f} decode dispatches, {steps:.0f} steps, "
                f"{(c1['stat_dispatch_s'] - c0['stat_dispatch_s']) / disp * 1e3:.3f} ms of host "
                f"time a dispatch, {(c1['stat_fetch_wait_s'] - c0['stat_fetch_wait_s']):.3f} s "
                f"waiting on fetches, {c1['stat_prefill_chunks'] - c0['stat_prefill_chunks']:.0f} "
                f"prefill chunks")
    half = (w0 + w1) / 2
    ttft = [[(r.first - r.due) * 1e3 for r in due if r.ok and (r.due < half) == h] for h in (1, 0)]
    ctx.log(f"backlog: {c_open['queued']:.0f} queued at the window's opening, {c1['queued']:.0f} at "
            f"its close; ttft median {[_median(x) for x in ttft]} ms in its first and second "
            f"half ({[len(x) for x in ttft]} turns)")
    ctx.log(pages.line())
    metrics = ctx.read_metrics(stats)
    failed = sum(1 for r in due if not r.ok)
    del engine, load, pages  # the pool goes with the engine, before the reference runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = {}
    if args.check:
        from uvbench.reference import serve_check

        checks = serve_check.check(ctx, plan, [r for r in due if r.ok], settings["check"])
    return {"attempted": len(due), "failed": failed, "metrics": metrics, "checks": checks,
            "breakdown": trace.breakdown() if trace else None,
            "device_extra": {"busy_s": trace.busy_s, "window_s": trace.window_s} if trace else {}}


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def _late_due(load, w1: float) -> bool:
    """A turn due before the close that the scheduler has not sent yet, or
    is sending."""
    with load._cv:
        return load._submitting > 0 or (bool(load._heap) and load._heap[0][0] < w1)


def _sleep_until(t: float, tick=None) -> None:
    while True:
        if tick is not None:
            tick()
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.5))
