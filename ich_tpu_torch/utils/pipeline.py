"""Bounded pipelining of host loops over device work (counterpart of
:mod:`ich_tpu.utils.pipeline`).

CUDA work is queued asynchronously: a host loop that never fetches runs far
ahead of the card and holds every queued input and output in device memory,
while one that fetches every iteration leaves the card idle during the
fetch. ``fetch_pipelined`` keeps at most ``depth`` results queued and
fetches the oldest as new work is queued.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import torch


def _to_numpy(t: torch.Tensor):
    return t.cpu().numpy()


def fetch_pipelined(
    device_iter: Iterable,
    depth: int = 4,
    fetch: Optional[Callable] = None,
) -> Iterator:
    """Yield ``fetch(x)`` (default ``x.cpu().numpy()``) for each item of
    ``device_iter``, keeping at most ``depth`` items un-fetched. Fetching the
    oldest result waits for everything queued before it on the stream, so at
    most ``depth`` iterations' buffers are alive on the device."""
    fetch = fetch or _to_numpy
    q: deque = deque()
    for x in device_iter:
        q.append(x)
        if len(q) >= max(1, depth):
            yield fetch(q.popleft())
    while q:
        yield fetch(q.popleft())
