"""The serving loop's own record read against the device trace: each
turn's TTFT split into the five stages its request's marks bound, and the
device's idle time put down to what the loop's thread was doing then.

The program records (``ultravox_torch/inference/serving``): on each
``Request`` the marks ``submit_time``, ``admit_time``, ``admitted_time``,
``prefill_start_time``, ``first_token_time`` and ``first_emit_time``
(``time.monotonic``, seconds), always; and, while a ``SpanRecorder`` is set
as ``ServingEngine.spans``, the loop's spans (``time.monotonic_ns``; name,
start, end, parent, request, value). The device trace is torch.profiler's,
on its own clock: ``clock_offset`` maps the loop's clock onto it from one
reading taken inside a ``record_function`` named ``CLOCK_EVENT``.

Everything here is arithmetic on plain lists, so the tests feed it marks,
spans and intervals made by hand."""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# a turn's way to its first token, by the Request fields that bound it
MARKS = ("submit_time", "admit_time", "admitted_time", "prefill_start_time", "first_token_time",
         "first_emit_time")
STAGES = (("queue", "submit_time", "admit_time"),
          ("admit", "admit_time", "admitted_time"),
          ("prefill_wait", "admitted_time", "prefill_start_time"),
          ("prefill", "prefill_start_time", "first_token_time"),
          ("inflight", "first_token_time", "first_emit_time"))
CLOCK_EVENT = "uvbench.clock"
OUTSIDE = "outside a tick"  # the loop's thread in no span: between ticks, or unrecorded
# the loop's states in which a host-side change cannot give the device work
# sooner: it waits for work, or for the device itself
NOT_HOST_BOUND = ("wait", "readback")

Interval = Tuple[int, int]


def stage_seconds(marks: Sequence[Dict[str, float]]) -> Dict[str, List[float]]:
    """Each stage's seconds, one per turn; ``marks`` holds each turn's
    marks by the Request fields' names."""
    return {name: [m[b] - m[a] for m in marks] for name, a, b in STAGES}


def stage_shares(marks: Sequence[Dict[str, float]]) -> Optional[Dict[str, float]]:
    """Per stage, its seconds summed over the turns over their TTFT
    (first emit less submit) summed, in percent; None without a turn."""
    total = sum(m["first_emit_time"] - m["submit_time"] for m in marks)
    if not marks or total <= 0:
        return None
    return {name: 100.0 * sum(v) / total for name, v in stage_seconds(marks).items()}


def clock_offset(anchor_start_ns: int, anchor_reading_ns: int) -> int:
    """Add to a ``time.monotonic_ns`` stamp to place it on the profiler's
    timeline: the ``CLOCK_EVENT`` range's start there less the reading
    taken inside it."""
    return anchor_start_ns - anchor_reading_ns


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint ones."""
    out: List[List[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def idle_stretches(busy: Sequence[Interval], w0: int, w1: int) -> List[Interval]:
    """The parts of [w0, w1) outside ``busy`` (sorted, disjoint)."""
    out, cur = [], w0
    for s, t in busy:
        if t <= cur:
            continue
        if s >= w1:
            break
        if s > cur:
            out.append((cur, s))
        cur = t
        if cur >= w1:
            return out
    if cur < w1:
        out.append((cur, w1))
    return out


def innermost(rows: Sequence[tuple], offset: int = 0) -> List[Tuple[int, int, str]]:
    """The time the spans cover, cut into sorted disjoint segments, each
    named after the innermost span open in it (a tick's self time is
    "tick"); ``rows`` in the order they started, strictly nested, each
    moved by ``offset``."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name) of the open spans
    cur = 0

    def cut(a: int, b: int, name: str) -> None:
        if b > a:
            segs.append((a, b, name))

    for row in rows:
        name, s, t = row[0], row[1] + offset, row[2] + offset
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            cut(cur, end, top)
            cur = end
        if stack:
            cut(cur, s, stack[-1][1])
        stack.append((t, name))
        cur = s
    while stack:
        end, top = stack.pop()
        cut(cur, end, top)
        cur = end
    return segs


def idle_by_state(stretches: Sequence[Interval],
                  segs: Sequence[Tuple[int, int, str]]) -> Dict[str, int]:
    """Nanoseconds of the idle ``stretches`` under each innermost span of
    ``segs`` (both sorted and disjoint); what no span covers is
    ``OUTSIDE``. The values sum to the stretches' length."""
    out: Dict[str, int] = {}
    j = 0
    for a, b in stretches:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered = 0
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, t, name = segs[k]
            part = min(b, t) - max(a, s)
            if part > 0:
                out[name] = out.get(name, 0) + part
                covered += part
            k += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0) + (b - a - covered)
    return out


def host_bound_share(by_state: Dict[str, int]) -> Optional[float]:
    """The idle time during which the loop's thread was neither waiting
    for work nor for the device, over all the idle time, in percent."""
    total = sum(by_state.values())
    if total <= 0:
        return None
    return 100.0 * (total - sum(by_state.get(n, 0) for n in NOT_HOST_BOUND)) / total


def innermost_host_op(host: Sequence[Tuple[int, int, str]],
                      points: Sequence[int]) -> List[Optional[str]]:
    """For each of ``points`` (sorted), the name of the shortest host
    operation of ``host`` (sorted by start) that covers it, or None: the
    label ``uvbench/trace.py`` gives an idle gap's middle, for every gap."""
    out: List[Optional[str]] = []
    heap: List[Tuple[int, int, str]] = []  # (duration, end, name) of the started ones
    i = 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, t, name = host[i]
            heapq.heappush(heap, (t - s, t, name))
            i += 1
        while heap and heap[0][1] < p:  # ended: the points only grow
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out
