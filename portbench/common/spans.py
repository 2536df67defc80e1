"""Readings of the program's own ``torch.profiler`` ranges in a traced
window, from :class:`portbench.common.trace.TraceSummary`'s host events
(``cpu``), device operations (``device``) and launch records: the host
time inside a range, the device time of the work launched while a range is
open, from whatever thread, and the device's idle time inside a range.

Each range's instances are joined into their union first, so that nested
or overlapping instances, on one thread or several, count once.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

from portbench.common.trace import TraceSummary, _merge


def _union(trace: TraceSummary, name: str) -> List[Tuple[int, int]]:
    return _merge((s, t) for n, _, s, t in trace.cpu if n == name)


def host_s(trace: TraceSummary, name: str) -> float:
    """Host seconds inside the events named ``name``."""
    return sum(t - s for s, t in _union(trace, name)) / 1e9


def launched_device_s(trace: TraceSummary, name: str) -> float:
    """Device seconds of the operations whose launch call, on any thread,
    began while an event named ``name`` was open. Autograd's engine runs a
    card's backward nodes on a thread of its own, so the work of the main
    thread's ``backward`` is launched from there."""
    spans = _union(trace, name)
    starts = [s for s, _ in spans]
    total = 0
    for _, s, t, corr in trace.device:
        launch = trace._launch.get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[1]) - 1
        if i >= 0 and spans[i][1] >= launch[1]:
            total += t - s
    return total / 1e9


def idle_within_s(trace: TraceSummary, name: str) -> float:
    """Seconds inside the events named ``name`` in which no operation ran
    on the device: each event's time less the device's activity that
    falls inside it."""
    spans = _union(trace, name)
    busy = _merge((s, t) for _, s, t, _ in trace.device)
    covered, j = 0, 0
    for s, t in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < t:
            covered += min(t, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return (sum(t - s for s, t in spans) - covered) / 1e9
