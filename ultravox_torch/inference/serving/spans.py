"""What the serving loop's thread did, and when: an in-memory record of
spans, kept while a ``SpanRecorder`` is set as ``ServingEngine.spans``.

A span is a name, a start and an end (``time.monotonic_ns``: the clock of
the requests' marks), the index of the span it lies in (-1 for none), the
request it serves (-1 for none) and one integer: the steps of a decode
dispatch, the rounds of a speculative one, the tokens of a prefill chunk,
the events an emit handed out. The loop's spans nest strictly on its one
thread, so the innermost open span is each new span's parent.

The loop's spans (``NAMES``): ``tick`` (one ``_loop_tick``), and inside
it ``admit`` (one ``_admit`` call; inside it ``embed``, the tower,
projector and splice), ``prefill_chunk``, ``decode_dispatch``,
``spec_sync`` (the drain and history upload before a speculative
dispatch), ``spec_dispatch``, ``fetch`` (one in-flight entry; inside it
``readback``, the waits for the card, and ``emit``) and ``wait`` (the
loop idle, waiting for work). Each span with an engine counter of host
time covers the same code as that counter, from the same clock readings:
``stat_admit_s`` sums ``admit``, ``stat_prefill_s`` ``prefill_chunk``,
``stat_dispatch_s`` ``decode_dispatch`` and ``spec_dispatch``,
``spec_sync_s`` ``spec_sync`` and ``stat_fetch_wait_s`` ``fetch``.

The buffer holds at most ``capacity`` spans; those past it are counted in
``dropped``. Nothing is written out: a reader takes ``rows()``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

NAMES = ("tick", "admit", "embed", "prefill_chunk", "decode_dispatch", "spec_sync",
         "spec_dispatch", "fetch", "readback", "emit", "wait")

# (name, start ns, end ns, parent index, request id, value)
Span = Tuple[str, int, int, int, int, int]


class SpanRecorder:
    def __init__(self, capacity: int = 1 << 20):
        self.capacity = int(capacity)
        self.dropped = 0
        self._rows: List[list] = []
        self._open: List[int] = []  # indices of the open spans, outermost first

    def open(self, name: str, rid: int = -1, start: Optional[int] = None) -> int:
        """Start a span inside the innermost open one, at ``start`` (now
        when None). Returns its index, or -1 when the buffer is full."""
        rows = self._rows
        if len(rows) >= self.capacity:
            self.dropped += 1
            return -1
        if start is None:
            start = time.monotonic_ns()
        rows.append([name, start, start, self._open[-1] if self._open else -1, rid, 0])
        self._open.append(len(rows) - 1)
        return len(rows) - 1

    def close(self, index: int, value: int = 0, end: Optional[int] = None) -> None:
        """End span ``index`` at ``end`` (now when None), with any span an
        exception left open inside it."""
        if index < 0:
            return
        if end is None:
            end = time.monotonic_ns()
        stack = self._open
        while stack and stack[-1] >= index:
            row = self._rows[stack.pop()]
            row[2] = end
        self._rows[index][5] = value

    def rows(self) -> List[Span]:
        """The spans recorded so far, in the order they started."""
        return [tuple(r) for r in self._rows]
