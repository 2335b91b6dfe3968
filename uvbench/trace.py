"""One traced window of torch.profiler, reduced to what the metrics read:
the device's busy time (the union of its operations' intervals), each
device operation's time by name, the ten that took most time and the ten
longest idle gaps, each named by the innermost host operation that ran
across its middle."""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 120


def _cuda() -> bool:
    return torch.cuda.is_available()
HOST_LOOKBACK = 20000


class Trace:
    def __init__(self):
        self._prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.by_name: Dict[str, float] = {}
        self.top_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []

    def prepare(self) -> None:
        """Set the profiler up (this takes seconds) without recording."""
        from torch.autograd import profiler

        kw = {}
        try:  # the serving loop runs on a thread of its own
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._prof = profiler.profile(use_kineto=True, use_device="cuda" if _cuda() else None, **kw)
        self._prof._prepare_trace()

    def begin(self) -> None:
        """Open the traced window."""
        self._prof._start_trace()
        self._t0 = time.monotonic()

    def stop(self) -> None:
        """Close the window. The raw events are kept and reduced later
        (``reduce``), once the run no longer needs the interpreter: the
        reduction is Python over every event."""
        from torch.autograd import _disable_profiler

        if _cuda():
            torch.cuda.synchronize()
        self.window_s = time.monotonic() - self._t0
        self._result = _disable_profiler()
        self._prof = None

    def kernel_s(self, names) -> Optional[float]:
        """Device seconds of the operations whose function name starts
        with any of ``names`` (after its return type and namespaces, so
        "layer_norm_kernel<" is not "vectorized_layer_norm_kernel<"); None
        when none ran."""
        pat = re.compile(r"(?:^|[\s:])(?:" + "|".join(re.escape(n) for n in names) + ")")
        hits = [t for n, t in self.by_name.items() if pat.search(n)]
        return sum(hits) if hits else None

    def reduce(self) -> None:
        from torch.autograd import DeviceType

        events = self._result.events()
        dev, host = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        dev.sort()
        by_name: Dict[str, float] = {}
        merged: List[List[int]] = []
        for s, t, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.by_name = by_name
        self.busy_s = min(sum(t - s for s, t in merged) * 1e-9, self.window_s)
        self.top_ops = [(n[:NAME_CHARS], v) for n, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        host.sort()
        starts = [s for s, _, _ in host]
        labelled = []
        for g, a, b in gaps:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            # the innermost host operation that covers the middle started
            # shortly before it: look back over a bounded stretch
            covering = [(t - s, name) for s, t, name in host[max(0, i - HOST_LOOKBACK): i]
                        if t >= mid]
            label = min(covering)[1] if covering else "no host operation"
            labelled.append((label[:NAME_CHARS], g * 1e-9))
        self.idle_gaps = labelled
        self._result = None

    def breakdown(self) -> Dict[str, list]:
        return {"device_ops": [[n, v] for n, v in self.top_ops],
                "idle_gaps": [[n, v] for n, v in self.idle_gaps]}
