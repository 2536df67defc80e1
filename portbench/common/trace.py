"""The traced window, reduced: device time of the work launched inside the
host's profiler ranges, the device's busy time (the union of its
activity), the operations that took most device time and the longest idle
gaps by what the host was doing.

It reads the profiler's raw events (``kineto_results``), not the event
tree that ``prof.events()`` builds, which takes minutes over the hundreds
of thousands of events of a training window. A device operation is
charged to the host's call that launched it (the CUDA runtime or driver
call with its correlation id, whose name begins with ``cu``), and so to
every host range open on that call's thread at that moment.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

_NAME = 120  # characters kept of an operation's name in the breakdown


def _merge(spans):
    """The union of (start, end) spans, sorted."""
    out: List[Tuple[int, int]] = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


class TraceSummary:
    """``prof``: a finished ``torch.profiler.profile`` over the window."""

    def __init__(self, prof):
        self.cpu = []  # (name, thread, start_ns, end_ns)
        self.device = []  # (name, start_ns, end_ns, correlation id)
        self._launch = {}  # correlation id -> (thread, start_ns) of its launch call
        for e in prof.profiler.kineto_results.events():
            start, name = e.start_ns(), e.name()
            if e.device_type() == DeviceType.CPU:
                self.cpu.append((name, e.start_thread_id(), start, start + e.duration_ns()))
                if name.startswith("cu"):
                    self._launch[e.correlation_id()] = (e.start_thread_id(), start)
            elif not e.is_user_annotation():
                self.device.append((name, start, start + e.duration_ns(), e.correlation_id()))
        self._busy = None

    def range_device_s(self, name: str, contains: bool = False) -> float:
        """Device seconds of the work launched inside the host events named
        ``name`` (or whose name contains it), nested ones counted once."""
        spans = defaultdict(list)
        for n, tid, s, t in self.cpu:
            if (name in n) if contains else (n == name):
                spans[tid].append((s, t))
        merged = {tid: _merge(v) for tid, v in spans.items()}
        starts = {tid: [s for s, _ in v] for tid, v in merged.items()}
        total = 0
        for _, s, t, corr in self.device:
            launch = self._launch.get(corr)
            if launch is None or launch[0] not in merged:
                continue
            tid, at = launch
            i = bisect.bisect_right(starts[tid], at) - 1
            if i >= 0 and merged[tid][i][1] >= at:
                total += t - s
        return total / 1e9

    def range_count(self, name: str) -> int:
        return sum(n == name for n, *_ in self.cpu)

    def device_total_s(self) -> float:
        """Device seconds summed over every operation."""
        return sum(t - s for _, s, t, _ in self.device) / 1e9

    def _intervals(self) -> List[Tuple[int, int]]:
        if self._busy is None:
            self._busy = _merge((s, t) for _, s, t, _ in self.device)
        return self._busy

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(t - s for s, t in self._intervals()) / 1e9

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The ``n`` operations with most device time, and the ``n`` host
        activities under which the device stood idle longest: each gap
        named by the outermost host event spanning its middle, on the
        thread with most host events first, else ``host``."""
        ops: Dict[str, float] = defaultdict(float)
        for name, s, t, _ in self.device:
            ops[name[:_NAME]] += (t - s) / 1e9
        per_thread = defaultdict(list)
        for name, tid, s, t in self.cpu:
            per_thread[tid].append((s, -t, name))
        outer = {}
        for tid, evs in per_thread.items():
            evs.sort()
            top, end = [], -1
            for s, neg_t, name in evs:
                if s >= end:
                    top.append((s, -neg_t, name))
                    end = -neg_t
            outer[tid] = (top, [s for s, _, _ in top])
        order = sorted(outer, key=lambda tid: -len(per_thread[tid]))
        gaps: Dict[str, float] = defaultdict(float)
        busy = self._intervals()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid, name = (a + b) / 2, "host"
            for tid in order:
                top, starts = outer[tid]
                i = bisect.bisect_right(starts, mid) - 1
                if i >= 0 and top[i][1] >= mid:
                    name = top[i][2]
                    break
            gaps[name[:_NAME]] += (b - a) / 1e9

        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

        return {"device_ops": first(ops), "idle_gaps": first(gaps)}
